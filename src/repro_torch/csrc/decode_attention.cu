// Flash-decode for Hopper: one query token per (batch row, kv-head) group
// against a KV cache — the Pallas TPU kernel
// src/repro/kernels/decode_attention.py `_kernel` (pallas_call :80).
//
// q (B, K, G, D), k and v (B, K, T, D), f32 or bf16, any strides with a unit
// stride on D (the engine's (B, T, K, D) per-layer cache is read in place);
// kv_len (B,) int32 on the device.  For batch row b the allowed keys are the
// positions t < kv_len[b] (and t > kv_len[b] - 1 - window when window > 0);
// output = softmax(q . k * scale) over them . v, finalised as
// acc / max(l, 1e-37), in q's dtype; a row with no allowed key outputs 0.
// With an lse buffer the kernel also writes each (b, kv-head, head) row's
// log-sum-exp of its scaled scores over the allowed keys, M + log(L) in
// f32, and -inf for a row with no allowed key: a context-parallel caller
// runs the kernel on each shard of a cache and combines the shards' rows
// by these weights (kernels/decode_attention.py `combine_partials`).
// Cache rows past kv_len (stale rows of an earlier occupant of the slot) are
// never read.
//
// Two families of instances, chosen by q's dtype:
//   * f32 (`decode_attention_kernel`): plain FP32 on the CUDA cores, the
//     reference's 2e-5 (the agent's decode step is f32);
//   * bf16 (`decode_attention_tc_kernel`, the section "bf16 on the tensor
//     cores"), over a bf16 cache or int8 codes dequantised to bf16: both
//     products on the tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32).
//     Products are exact in f32; P is rounded to bf16 before P.V and l adds
//     the unrounded f32 p, inside the zoo's 2e-2 x max|v| gate.
//
// Two variants of the same kernel, as template arguments:
//   * slot positions (kSlots, the ring-buffer cache of a sliding window):
//     slot_pos (B, T) int32 holds the true position of the token in each
//     cache slot (-1 for an empty slot) and the query's position is
//     kv_len[b] - 1.  Slot t is allowed where 0 <= slot_pos[b, t] <= q_pos
//     and, with a window, slot_pos[b, t] > q_pos - window.  The splits then
//     cut all T slots and each key is masked by its slot's position;
//   * int8 codes (CT = int8_t, the quantised cache): k and v hold int8
//     codes (B, K, T, D) and k_scale / v_scale f32 (B, K, T) per-row
//     scales, read through their strides.  A row is dequantised while it is
//     staged into shared memory, as the reference's `dequantize_kv` does:
//     code * scale in f32, rounded to q's dtype (then widened for the dot).
//     These rows go by plain loads, not cp.async.
//
// What bounds both: bytes.  Each allowed cache row is read once for all G
// heads, 2 * D * 4 bytes per (row, kv-head) in f32, against 4 * G * D flops:
// G/2 flops per byte, far below the card's ~20 FP32 flops per byte.  At the
// agent's decode step (8 slots, K=4, kv_len ~170, D=64) that is ~3 MB, ~1 us
// at 3.35 TB/s, so latency and launches cost more than the work.  The int8
// cache moves D + 4 bytes a row instead of 4 D (f32) or 2 D (bf16).
//
// Design of the f32 kernel (the TPU kernel walks T in order inside one
// core; a CTA per (b, kv-head) would leave most of 132 SMs idle at 8 slots
// x 4 kv-heads):
//   * one launch, grid (split, kv-head, batch row) fixed by the shape, so a
//     CUDA graph can hold it.  Each CTA reads kv_len[b] on the device and
//     takes split `blockIdx.x` of the allowed range
//     [max(0, kv_len - window), min(kv_len, T)) — all of [0, T) with slot
//     positions — cut into n_split near-equal pieces (`split_range`,
//     mirrored by kernels/decode_attention.py), so every CTA of a
//     (b, kv-head) has about the same rows whatever kv_len;
//   * 32-row tiles of K and V stream through a ring of 2-3 tiles in shared
//     memory by 16-byte cp.async (plain loads when a row is not 16-byte
//     aligned, or holds int8 codes), so the next tile's copy overlaps this
//     tile's math;
//   * warp w owns heads w, w+4, w+8, w+12; lane j scores key j of the tile
//     for those heads (float4 reads of its K row against the broadcast
//     query), the warp keeps the running max and sum with shuffles, and
//     P.V walks the tile's keys with p broadcast by shuffle and each lane
//     holding float4 columns of the accumulator (lane groups take keys in
//     turn when D/4 < 32 and are summed at the end);
//   * each CTA writes its (m, l, acc) to a workspace the wrapper keeps, then
//     takes a ticket (__threadfence + atomicAdd on a per-(b, kv-head)
//     counter); the last CTA to arrive merges the splits in split order and
//     resets the counter to 0 for the next call or graph replay.  With one
//     split the CTA writes the output directly.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;       // cache rows per tile: one per lane
constexpr int kMaxG = 16;       // query heads per kv-head
constexpr int kHeadsPerWarp = kMaxG / kWarps;
constexpr int kMaxSplits = 32;  // splits of one (b, kv-head)

struct Strides {  // element strides; D has stride 1
  long long q[3];   // b, k, g
  long long k[3];   // b, k, t
  long long v[3];   // b, k, t
  long long o[3];   // b, k, g
  long long sp[2];  // slot_pos: b, t
  long long ks[3];  // k_scale: b, k, t
  long long vs[3];  // v_scale: b, k, t
};

// the log-sum-exp of a row with no allowed key: -inf
__device__ __forceinline__ float lse_none() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Split `split` of n_split of the allowed range [max(0, kv_len - window),
// min(kv_len, T)) of n rows (the caller passes kl = T and no window for the
// slot-position variant, whose range is every slot): rows [n * split / n_split, n * (split + 1) /
// n_split) of it, so the pieces differ by at most one row and none is
// empty while n >= n_split.  kernels/decode_attention.py `split_range` is
// the same.
__device__ __forceinline__ void split_range(int kl, int T_len, int window, int n_split,
                                            int split, int* lo, int* hi) {
  const int hi_all = max(0, min(kl, T_len));
  const int lo_all = window > 0 ? max(0, kl - window) : 0;
  const long long n = max(0, hi_all - lo_all);
  *lo = lo_all + (int)(n * split / n_split);
  *hi = lo_all + (int)(n * (split + 1) / n_split);
}

// shared-memory row of a K/V tile: DP elements plus 16 bytes, so rows stay
// 16-byte aligned for cp.async and lanes reading their own rows hit
// different banks
template <typename T, int DP>
__host__ __device__ constexpr int row_elems() { return DP + 16 / (int)sizeof(T); }
template <int DP>
__host__ __device__ constexpr int ring_stages() { return DP >= 256 ? 2 : 3; }

// Rows [t0, t0 + rows) of one kv-head's int8 K and V codes, dequantised
// into the shared-memory tiles: code * scale in f32, rounded to T (plain
// loads).  Commits an (empty) cp.async group, as stage_tile does.
template <typename T, int RS>
__device__ __forceinline__ void stage_tile_int8(T* Ks, T* Vs, const int8_t* kb, const int8_t* vb,
                                                long long sk, long long sv, const float* ksb,
                                                const float* vsb, long long sks, long long svs,
                                                int t0, int rows, int D, int tid) {
  for (int i = tid; i < rows * D; i += kThreads) {
    const int row = i / D, d = i % D;
    const long long t = t0 + row;
    store(Ks + row * RS + d, (float)kb[t * sk + d] * ksb[t * sks]);
    store(Vs + row * RS + d, (float)vb[t * sv + d] * vsb[t * svs]);
  }
  cp_async_commit();
}

template <typename T, int DP>
constexpr size_t smem_bytes(int G) {
  return (size_t)G * DP * sizeof(float) +
         (size_t)ring_stages<DP>() * 2 * kKeys * row_elems<T, DP>() * sizeof(T);
}

// T: q's (and the shared-memory rows') type; CT: the cache's, T or int8_t
// (codes, dequantised at staging); kSlots: keys masked by slot_pos
template <typename T, typename CT, int DP, bool kSlots>
__global__ void __launch_bounds__(kThreads, 1)
decode_attention_kernel(const T* __restrict__ q, const CT* __restrict__ k,
                        const CT* __restrict__ v, const int* __restrict__ kv_len,
                        const int* __restrict__ slot_pos, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, T* __restrict__ out, int G,
                        int T_len, int D, float scale, int window, int vec, Strides st,
                        float* __restrict__ part_ml, float* __restrict__ part_acc,
                        int* __restrict__ counters, float* __restrict__ lse) {
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  constexpr int RS = row_elems<T, DP>();
  constexpr int NS = ring_stages<DP>();
  constexpr int CH = DP / 4;                   // float4 columns of a row
  constexpr int LG = CH < 32 ? 32 / CH : 1;    // lane groups walking keys in turn
  constexpr int CPL = CH < 32 ? 1 : CH / 32;   // float4 columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  T* ring = reinterpret_cast<T*>(smem_raw + (size_t)G * DP * sizeof(float));
  __shared__ int is_last;
  __shared__ float split_m[kMaxG][kMaxSplits];       // the merge's maxima,
  __shared__ float weights[kMaxG][kMaxSplits + 1];  // sums, then weights

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int bk = b * gridDim.y + kh;
  const int lg = lane / CH % LG, col = CH < 32 ? lane % CH : lane;
  const int kl = kv_len[b];
  const int q_pos = kl - 1;  // the query's position (slot-position variant)
  int lo, hi;
  split_range(kSlots ? T_len : kl, T_len, kSlots ? 0 : window, n_split, split, &lo, &hi);
  const int n = max(0, hi - lo);

  float m[kHeadsPerWarp], l[kHeadsPerWarp];
  float4 acc[kHeadsPerWarp][CPL];
#pragma unroll
  for (int h = 0; h < kHeadsPerWarp; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[h][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  if (n > 0) {
    const T* qb = q + b * st.q[0] + kh * st.q[1];
    const CT* kb = k + b * st.k[0] + kh * st.k[1];
    const CT* vb = v + b * st.v[0] + kh * st.v[1];
    const int ntiles = (n + kKeys - 1) / kKeys;
    auto stage = [&](int t) {
      T* Ks = ring + (size_t)(t % NS) * 2 * kKeys * RS;
      const int r0 = lo + t * kKeys;
      if constexpr (kQuant)
        stage_tile_int8<T, RS>(Ks, Ks + kKeys * RS, kb, vb, st.k[2], st.v[2],
                               k_scale + b * st.ks[0] + kh * st.ks[1],
                               v_scale + b * st.vs[0] + kh * st.vs[1], st.ks[2], st.vs[2], r0,
                               min(kKeys, hi - r0), D, tid);
      else
        stage_tile<T, RS, kThreads>(Ks, Ks + kKeys * RS, kb, vb, st.k[2], st.v[2], r0,
                                    min(kKeys, hi - r0), D, vec, tid);
    };
#pragma unroll
    for (int t = 0; t < NS - 1; ++t) {
      if (t < ntiles) stage(t);
      else cp_async_commit();
    }
    // the query, while the first tiles are in flight
    for (int i = tid; i < G * DP; i += kThreads) {
      const int g = i / DP, d = i % DP;
      Qs[i] = d < D ? to_f32(qb[g * st.q[2] + d]) : 0.f;
    }
    if (D < DP) {  // the ring's columns past D are never copied: zero them once
      for (int i = tid; i < NS * 2 * kKeys * (DP - D); i += kThreads)
        store(ring + (size_t)(i / (DP - D)) * RS + D + i % (DP - D), 0.f);
    }
    for (int t = 0; t < ntiles; ++t) {
      if (t + NS - 1 < ntiles) stage(t + NS - 1);
      else cp_async_commit();
      cp_async_wait<NS - 1>();
      __syncthreads();  // tile t (and the query, the zeroed columns) visible
      const T* Ks = ring + (size_t)(t % NS) * 2 * kKeys * RS;
      const T* Vs = Ks + kKeys * RS;
      const int rows = min(kKeys, hi - (lo + t * kKeys));
      bool valid = lane < rows;
      if constexpr (kSlots) {  // the key's slot must hold an allowed position
        if (valid) {
          const int sp = slot_pos[b * st.sp[0] + (long long)(lo + t * kKeys + lane) * st.sp[1]];
          valid = sp >= 0 && sp <= q_pos && (window <= 0 || sp > q_pos - window);
        }
      }

      float sc[kHeadsPerWarp];
#pragma unroll
      for (int h = 0; h < kHeadsPerWarp; ++h) sc[h] = 0.f;
      const T* krow = Ks + lane * RS;
#pragma unroll 4
      for (int d = 0; d < DP; d += 4) {
        const float4 kv = load4(krow + d);
#pragma unroll
        for (int h = 0; h < kHeadsPerWarp; ++h) {
          const int g = warp + kWarps * h;
          if (g < G) sc[h] = dot4(*reinterpret_cast<const float4*>(Qs + g * DP + d), kv, sc[h]);
        }
      }
      float p[kHeadsPerWarp];
#pragma unroll
      for (int h = 0; h < kHeadsPerWarp; ++h) {
        p[h] = 0.f;
        if (warp + kWarps * h >= G) continue;  // warp-uniform
        const float s = sc[h] * scale;
        const float m_new = fmaxf(m[h], warp_max(valid ? s : kNegInf));
        const float corr = expf(m[h] - m_new);
        p[h] = valid ? expf(s - m_new) : 0.f;
        l[h] = l[h] * corr + warp_sum(p[h]);
        m[h] = m_new;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          acc[h][c].x *= corr;
          acc[h][c].y *= corr;
          acc[h][c].z *= corr;
          acc[h][c].w *= corr;
        }
      }
      for (int j0 = 0; j0 < rows; j0 += LG) {
        const int j = j0 + lg;
        float4 vx[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          vx[c] = j < rows ? load4(Vs + j * RS + 4 * (col + 32 * c)) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int h = 0; h < kHeadsPerWarp; ++h) {
          if (warp + kWarps * h >= G) continue;  // warp-uniform
          const float pj = __shfl_sync(0xffffffffu, p[h], j & 31);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            acc[h][c].x = fmaf(pj, vx[c].x, acc[h][c].x);
            acc[h][c].y = fmaf(pj, vx[c].y, acc[h][c].y);
            acc[h][c].z = fmaf(pj, vx[c].z, acc[h][c].z);
            acc[h][c].w = fmaf(pj, vx[c].w, acc[h][c].w);
          }
        }
      }
      __syncthreads();  // tile t consumed: its buffer may be refilled
    }
  }
#pragma unroll
  for (int h = 0; h < kHeadsPerWarp; ++h) {  // sum the lane groups' keys
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
#pragma unroll
      for (int off = CH; off < 32; off <<= 1) {
        acc[h][c].x += __shfl_xor_sync(0xffffffffu, acc[h][c].x, off);
        acc[h][c].y += __shfl_xor_sync(0xffffffffu, acc[h][c].y, off);
        acc[h][c].z += __shfl_xor_sync(0xffffffffu, acc[h][c].z, off);
        acc[h][c].w += __shfl_xor_sync(0xffffffffu, acc[h][c].w, off);
      }
    }
  }

  if (n_split == 1) {  // the whole range in this CTA: finalise here
#pragma unroll
    for (int h = 0; h < kHeadsPerWarp; ++h) {
      const int g = warp + kWarps * h;
      if (g >= G || lg != 0) continue;
      T* ob = out + b * st.o[0] + kh * st.o[1] + g * st.o[2];
      const float inv = 1.f / fmaxf(l[h], 1e-37f);
      if (lse != nullptr && lane == 0)  // m and l are the same in every lane
        lse[(size_t)bk * G + g] = l[h] > 0.f ? m[h] + logf(l[h]) : lse_none();
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d0 = 4 * (col + 32 * c);
        const float a[4] = {acc[h][c].x, acc[h][c].y, acc[h][c].z, acc[h][c].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d0 + e < D) store(ob + d0 + e, a[e] * inv);
      }
    }
    return;
  }

  // this split's partial state, then the ticket
  const size_t part = ((size_t)bk * n_split + split) * G;
#pragma unroll
  for (int h = 0; h < kHeadsPerWarp; ++h) {
    const int g = warp + kWarps * h;
    if (g >= G || lg != 0) continue;
    if (lane == 0) {
      part_ml[(part + g) * 2] = m[h];
      part_ml[(part + g) * 2 + 1] = l[h];
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      *reinterpret_cast<float4*>(part_acc + (part + g) * DP + 4 * (col + 32 * c)) = acc[h][c];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(counters + bk, 1);
    is_last = ticket == n_split - 1;
    if (is_last) counters[bk] = 0;  // every split has arrived: reset for the next call
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // merge the splits in split order (the same sums whichever CTA is last):
  // M = max m, w_s = e^(m_s - M), L = sum l_s w_s, out = sum acc_s w_s /
  // max(L, 1e-37); a split with no allowed row has l = 0 and weight 0
  const size_t base = (size_t)bk * n_split;
  for (int i = tid; i < G * n_split; i += kThreads) {  // every (m, l) in one round trip
    const int g = i / n_split, s = i % n_split;
    const size_t pi = (base + s) * G + g;
    split_m[g][s] = __ldcg(part_ml + pi * 2);
    weights[g][s] = __ldcg(part_ml + pi * 2 + 1);
  }
  __syncthreads();
  if (tid < G) {  // one thread a head: its weights and their sum
    const int g = tid;
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s)
      if (weights[g][s] > 0.f) M = fmaxf(M, split_m[g][s]);
    float L = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ls = weights[g][s];
      const float w = ls > 0.f ? expf(split_m[g][s] - M) : 0.f;
      weights[g][s] = w;
      L = fmaf(ls, w, L);
    }
    weights[g][kMaxSplits] = fmaxf(L, 1e-37f);
    if (lse != nullptr) lse[(size_t)bk * G + g] = L > 0.f ? M + logf(L) : lse_none();
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = weights[g][s];
      if (w > 0.f) A = fmaf(__ldcg(part_acc + ((base + s) * G + g) * DP + d), w, A);
    }
    store(out + b * st.o[0] + kh * st.o[1] + g * st.o[2] + d, A / weights[g][kMaxSplits]);
  }
}

// -- bf16 on the tensor cores --------------------------------------------------
//
// The G <= 16 query heads of a (b, kv-head) are the 16 rows of an m16n8k16
// tile (rows past G are zero).  A tile holds kTcKeys = 64 cache rows and
// warp w takes rows [16 w, 16 w + 16): S = Q K^T (2 n-tiles, D rounded up
// to 16 deep), its own online softmax over them in registers (base-2
// exponentials of scale * log2 e), P rounded to bf16 as the A operand of
// O += P V (V by ldmatrix.trans).  K and V tiles come by tensor-map copies
// (64-column boxes of 64 rows, 128-byte swizzled, one thread issuing them,
// each stage counted on an mbarrier): they streamed the cache faster than
// 16-byte cp.async from every thread on the H100 (PERF.md).  int8
// codes (dequantised) and rows that are not 16-byte aligned are stored by
// plain loads into the same layout.  After
// the split's last tile the four warps' (m, l, acc) are combined in shared
// memory; then, as in the f32 kernel, the CTA writes the output (one split)
// or its partials and a ticket, and the last CTA of the (b, kv-head) merges
// the splits: their (m, l) first, then the f32 partials, staged through
// shared memory by one bulk copy a split, every thread summing its own
// columns over the splits.
constexpr int kTcKeys = 64;  // cache rows per tile: 16 per warp
template <int DP>
__host__ __device__ constexpr int tc_stages() { return DP >= 128 ? 3 : 4; }
template <int DP>
__host__ __device__ constexpr int tc_chunks() { return DP < 64 ? 1 : DP / 64; }
template <int DP>
__host__ __device__ constexpr int tc_qbytes() {  // the query's rows, then the ring (1024-aligned)
  return ((kMaxG * (DP + 8) * 2 + 1023) / 1024) * 1024;
}
template <int DP>
__host__ __device__ constexpr int tc_ring() {  // ring elements: NS stages of K, V chunks
  return tc_stages<DP>() * 2 * tc_chunks<DP>() * kTcKeys * 64;
}
template <int DP>
constexpr size_t tc_smem_bytes() {
  return 1024 + tc_qbytes<DP>() + 2 * (size_t)tc_ring<DP>();
}

// CT: the cache's type, bf16 or int8_t (codes, dequantised to bf16 at
// staging); kSlots: keys masked by slot_pos
template <typename CT, int DP, bool kSlots>
__global__ void __launch_bounds__(kThreads, 1)
decode_attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const CT* __restrict__ k,
                           const CT* __restrict__ v, const int* __restrict__ kv_len,
                           const int* __restrict__ slot_pos, const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ out,
                           int G, int T_len, int D, float scale, int window, int vec, Strides st,
                           float* __restrict__ part_ml, float* __restrict__ part_acc,
                           int* __restrict__ counters, float* __restrict__ lse,
                           const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv) {
  using bf16 = __nv_bfloat16;
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  constexpr int RS = DP + 8;                    // a query row (elements)
  constexpr int NS = tc_stages<DP>();
  constexpr int KC = tc_chunks<DP>();           // 64-column chunks of a tile
  constexpr int kChunk = kTcKeys * 64;          // elements
  constexpr int kRing = tc_ring<DP>();
  constexpr int kAS = DP + 4;                   // a warp's f32 accumulator row, combining
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + tc_qbytes<DP>());
  float* wacc = reinterpret_cast<float*>(ring);  // after the loop: the warps' accumulators
  __shared__ int is_last;
  __shared__ float wm[kWarps][kMaxG], wl[kWarps][kMaxG];
  __shared__ float split_m[kMaxG][kMaxSplits];       // the merge's maxima,
  __shared__ float weights[kMaxG][kMaxSplits + 1];  // sums, then weights
  __shared__ __align__(8) uint64_t full_bar[NS];     // a stage's tile has landed
  __shared__ __align__(8) uint64_t merge_bar;        // a chunk of partials has landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int bk = b * gridDim.y + kh;
  const int kl = kv_len[b];
  const int q_pos = kl - 1;  // the query's position (slot-position variant)
  const int DQ = (D + 15) & ~15;
  const bool tma = !kQuant && vec;
  int lo, hi;
  split_range(kSlots ? T_len : kl, T_len, kSlots ? 0 : window, n_split, split, &lo, &hi);
  const int n = max(0, hi - lo);
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(&full_bar[i], 1);
    mbar_init(&merge_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (n > 0) {
    const bf16* qb = q + b * st.q[0] + kh * st.q[1];
    const CT* kb = k + b * st.k[0] + kh * st.k[1];
    const CT* vb = v + b * st.v[0] + kh * st.v[1];
    const int ntiles = (n + kTcKeys - 1) / kTcKeys;
    if (!tma) {  // plain stores never write the columns past D: zero the ring once
      for (int i = tid; i < kRing / 8; i += kThreads)
        reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
      __syncthreads();
    }
    // tile t's 64 rows from lo + 64 t into stage t % NS (rows past the
    // split's are masked: finite cache rows, or zeros past T); the element
    // (row, col) of a chunk sits at unit ((col % 64) / 8) ^ (row % 8)
    const int kc = (D + 63) / 64;
    auto stage = [&](int t) {
      const int slot = t % NS;
      bf16* Ks = ring + (size_t)slot * 2 * KC * kChunk;
      bf16* Vs = Ks + KC * kChunk;
      const int r0 = lo + t * kTcKeys;
      if (tma) {
        if (tid == 0) {
          mbar_expect(&full_bar[slot], 2u * 2 * kc * kChunk);
          for (int j = 0; j < kc; ++j) {
            tma_load_4d(Ks + j * kChunk, &tmk, 64 * j, r0, kh, b, &full_bar[slot]);
            tma_load_4d(Vs + j * kChunk, &tmv, 64 * j, r0, kh, b, &full_bar[slot]);
          }
        }
        return;
      }
      const int rows = min(kTcKeys, hi - r0);
      for (int row = tid / kCopyTPR; row < kTcKeys; row += kThreads / kCopyTPR) {
        const long long tr = r0 + row;
        const CT* kr = kb + tr * st.k[2];
        const CT* vr = vb + tr * st.v[2];
        float ksc = 1.f, vsc = 1.f;
        if constexpr (kQuant) {  // code * scale in f32, rounded to bf16
          if (row < rows) {
            ksc = k_scale[b * st.ks[0] + kh * st.ks[1] + tr * st.ks[2]];
            vsc = v_scale[b * st.vs[0] + kh * st.vs[1] + tr * st.vs[2]];
          }
        }
        bf16* kd = Ks + row * 64;
        bf16* vd = Vs + row * 64;
        for (int col = tid % kCopyTPR; col < D; col += kCopyTPR) {
          const float x = row < rows ? to_f32(kr[col]) * ksc : 0.f;
          const float y = row < rows ? to_f32(vr[col]) * vsc : 0.f;
          const int at = (col >> 6) * kChunk + ((((col & 63) >> 3) ^ (row & 7)) << 3) + (col & 7);
          kd[at] = __float2bfloat16_rn(x);
          vd[at] = __float2bfloat16_rn(y);
        }
      }
      if (tid == 0) mbar_arrive(&full_bar[slot]);
    };
#pragma unroll 1
    for (int t = 0; t < NS - 1 && t < ntiles; ++t) stage(t);
    // the query (rows past G and columns past D zero), while the first
    // tiles are in flight
    for (int i = tid; i < kMaxG * DP; i += kThreads) {
      const int g = i / DP, d = i % DP;
      Qs[g * RS + d] = g < G && d < D ? qb[g * st.q[2] + d] : __float2bfloat16_rn(0.f);
    }
    const bf16* qfrag = Qs + (lane & 15) * RS + 8 * (lane >> 4);
    const int kx = lane & 7;  // a lane's rows sit at (row % 8) = lane % 8: its swizzle
    for (int t = 0; t < ntiles; ++t) {
      if (t + NS - 1 < ntiles) stage(t + NS - 1);
      mbar_wait(&full_bar[t % NS], (t / NS) & 1);
      __syncthreads();  // tile t (and the query) visible
      const int r0 = lo + t * kTcKeys, rows = min(kTcKeys, hi - r0);
      if (16 * warp < rows) {  // warp-uniform
        const bf16* Ks = ring + (size_t)(t % NS) * 2 * KC * kChunk + 16 * warp * 64;
        const bf16* Vs = Ks + KC * kChunk;
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const bf16* kfrag = Ks + ((lane & 7) + 8 * (lane >> 4)) * 64;
        const int ku = (lane >> 3) & 1;
        auto qk_step = [&](int kk) {
          uint32_t a[4], kf[4];
          ldmatrix_x4(a, qfrag + kk);
          ldmatrix_x4(kf, kfrag + (kk >> 6) * kChunk + (((((kk & 63) >> 3) + ku) ^ kx) << 3));
          mma_bf16(sc[0], a, kf[0], kf[1]);
          mma_bf16(sc[1], a, kf[2], kf[3]);
        };
        if (DQ == DP) {  // the instance's full depth: one straight run
#pragma unroll
          for (int kk = 0; kk < DP; kk += 16) qk_step(kk);
        } else {
#pragma unroll 4
          for (int kk = 0; kk < DQ; kk += 16) qk_step(kk);
        }
        // scores in log2 units, keys past the range (or in a slot the
        // query may not see) at -inf: exactly zero weight
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kt = 16 * warp + 8 * j + 2 * t4 + e;  // key 8 j + 2 t4 + e of the warp's 16
            bool ok = kt < rows;
            if constexpr (kSlots) {  // the key's slot must hold an allowed position
              if (ok) {
                const int sp = slot_pos[b * st.sp[0] + (long long)(r0 + kt) * st.sp[1]];
                ok = sp >= 0 && sp <= q_pos && (window <= 0 || sp > q_pos - window);
              }
            }
            sc[j][e] = ok ? sc[j][e] * sl2 : -INFINITY;
            sc[j][2 + e] = ok ? sc[j][2 + e] * sl2 : -INFINITY;
          }
        float corr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = fmaxf(fmaxf(sc[0][2 * i], sc[0][2 * i + 1]),
                           fmaxf(sc[1][2 * i], sc[1][2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[i], mx);  // m starts finite (kNegInf): never inf - inf
          corr[i] = fast_exp2(m[i] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = fast_exp2(sc[j][2 * i + e] - m_new);
              sc[j][2 * i + e] = p;
              sum += p;  // l sums the f32 p, before P is rounded to bf16
            }
          l[i] = l[i] * corr[i] + sum;
          m[i] = m_new;
        }
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {  // a max moved
#pragma unroll
          for (int j = 0; j < DP / 8; ++j) {
            acc[j][0] *= corr[0];
            acc[j][1] *= corr[0];
            acc[j][2] *= corr[1];
            acc[j][3] *= corr[1];
          }
        }
        const uint32_t a[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                               pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
        const bf16* vfrag = Vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * 64;
        const int vu = lane >> 4;
        auto pv_step = [&](int j) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vfrag + (j >> 2) * kChunk + ((((2 * j) & 7) + vu) ^ kx) * 8);
          mma_bf16(acc[2 * j], a, vf[0], vf[1]);
          mma_bf16(acc[2 * j + 1], a, vf[2], vf[3]);
        };
        if (DQ == DP) {  // every column: no per-pair branch
#pragma unroll
          for (int j = 0; j < DP / 16; ++j) pv_step(j);
        } else {
#pragma unroll
          for (int j = 0; j < DP / 16; ++j)
            if (16 * j < DQ) pv_step(j);
        }
      }
      __syncthreads();  // tile t consumed: its buffer may be refilled
    }
  }

  // combine the four warps: wm/wl per (warp, head), their accumulators
  // through the (now free) ring; a warp with no allowed key has l = 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (t4 == 0) {
      wm[warp][g4 + 8 * i] = m[i];
      wl[warp][g4 + 8 * i] = l[i];
    }
  }
  float* wa = wacc + (size_t)warp * kMaxG * kAS;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(wa + (g4 + 8 * i) * kAS + 8 * j + 2 * t4) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
  __syncthreads();
  if (tid < G) {  // one thread a head: the warps' weights, M and L
    const int g = tid;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      if (wl[w][g] > 0.f) M = fmaxf(M, wm[w][g]);
    float L = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float lw = wl[w][g];
      const float x = lw > 0.f ? fast_exp2(wm[w][g] - M) : 0.f;
      wm[w][g] = x;
      L = fmaf(lw, x, L);
    }
    wl[0][g] = M;
    wl[1][g] = L;
  }
  __syncthreads();
  const float ln2 = 0.6931471805599453f;
  if (n_split == 1) {  // the whole range in this CTA: finalise here
    if (lse != nullptr && tid < G) {
      const float L = wl[1][tid];
      lse[(size_t)bk * G + tid] = L > 0.f ? (wl[0][tid] + log2f(L)) * ln2 : lse_none();
    }
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) A = fmaf(wacc[((size_t)w * kMaxG + g) * kAS + d], wm[w][g], A);
      store(out + b * st.o[0] + kh * st.o[1] + g * st.o[2] + d, A / fmaxf(wl[1][g], 1e-37f));
    }
    return;
  }

  // this split's partial state, then the ticket
  const size_t part = ((size_t)bk * n_split + split) * G;
  if (tid < G) {
    part_ml[(part + tid) * 2] = wl[0][tid];
    part_ml[(part + tid) * 2 + 1] = wl[1][tid];
  }
  for (int i = tid; i < G * (DP / 4); i += kThreads) {
    const int g = i / (DP / 4), d = 4 * (i % (DP / 4));
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x = wm[w][g];
      const float4 y = *reinterpret_cast<const float4*>(wacc + ((size_t)w * kMaxG + g) * kAS + d);
      A.x = fmaf(y.x, x, A.x);
      A.y = fmaf(y.y, x, A.y);
      A.z = fmaf(y.z, x, A.z);
      A.w = fmaf(y.w, x, A.w);
    }
    *reinterpret_cast<float4*>(part_acc + (part + g) * DP + d) = A;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(counters + bk, 1);
    is_last = ticket == n_split - 1;
    if (is_last) counters[bk] = 0;  // every split has arrived: reset for the next call
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // merge the splits in split order (the same sums whichever CTA is last):
  // M = max m, w_s = 2^(m_s - M), L = sum l_s w_s, out = sum acc_s w_s /
  // max(L, 1e-37); a split with no allowed row has l = 0 and weight 0
  const size_t base = (size_t)bk * n_split;
  for (int i = tid; i < G * n_split; i += kThreads) {  // every (m, l) in one round trip
    const int g = i / n_split, s = i % n_split;
    const size_t pi = (base + s) * G + g;
    split_m[g][s] = __ldcg(part_ml + pi * 2);
    weights[g][s] = __ldcg(part_ml + pi * 2 + 1);
  }
  __syncthreads();
  if (tid < G) {  // one thread a head: its weights and their sum
    const int g = tid;
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s)
      if (weights[g][s] > 0.f) M = fmaxf(M, split_m[g][s]);
    float L = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ls = weights[g][s];
      const float w = ls > 0.f ? fast_exp2(split_m[g][s] - M) : 0.f;
      weights[g][s] = w;
      L = fmaf(ls, w, L);
    }
    weights[g][kMaxSplits] = fmaxf(L, 1e-37f);
    if (lse != nullptr) lse[(size_t)bk * G + g] = L > 0.f ? (M + log2f(L)) * ln2 : lse_none();
  }
  // the partials in chunks of CH floats of each split's G x DP block, one
  // bulk copy a split (the other CTAs' stores, seen through the ticket, and
  // this CTA's own generic accesses to the ring are fenced to the async
  // proxy first)
  constexpr int kRingFloats = kRing * (int)sizeof(bf16) / 4;
  const int total = G * DP;
  const int CH = min(total, (kRingFloats / n_split) & ~3);
  float* buf = wacc;
  for (int f0 = 0, round = 0; f0 < total; f0 += CH, ++round) {
    const int ch = min(CH, total - f0);
    __syncthreads();  // the weights are ready; the previous chunk is consumed
    if (tid == 0) {
      asm volatile("fence.proxy.async;\n" ::: "memory");
      mbar_expect(&merge_bar, 4u * n_split * ch);
      for (int s = 0; s < n_split; ++s)
        bulk_copy(buf + s * CH, part_acc + (base + s) * G * DP + f0, 4u * ch, &merge_bar);
    }
    mbar_wait(&merge_bar, round & 1);
    for (int c = 4 * tid; c < ch; c += 4 * kThreads) {
      const int f = f0 + c, g = f / DP, d = f % DP;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < n_split; ++s) {
        const float w = weights[g][s];
        const float4 y = *reinterpret_cast<const float4*>(buf + s * CH + c);
        A.x = fmaf(y.x, w, A.x);
        A.y = fmaf(y.y, w, A.y);
        A.z = fmaf(y.z, w, A.z);
        A.w = fmaf(y.w, w, A.w);
      }
      const float inv = 1.f / weights[g][kMaxSplits];
      bf16* ob = out + b * st.o[0] + kh * st.o[1] + g * st.o[2];
      const float a4[4] = {A.x, A.y, A.z, A.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < D) ob[d + e] = __float2bfloat16_rn(a4[e] * inv);
    }
  }
}

struct Args {  // one call's operands besides the template choice
  const void *q, *k, *v;
  const int *kv_len, *slot_pos;
  const float *k_scale, *v_scale;
  void* out;
  int B, K, G, T_len, D;
  float scale;
  int window, n_split, vec;
  Strides st;
  float *part_ml, *part_acc;
  int* counters;
  float* lse;
  cudaStream_t stream;
};

template <typename T, typename CT, int DP, bool kSlots>
cudaError_t launch(const Args& a) {
  static int attr_device = -1;  // the shared-memory ceiling is per device
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != attr_device) {
    err = cudaFuncSetAttribute(decode_attention_kernel<T, CT, DP, kSlots>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<T, DP>(kMaxG));
    if (err != cudaSuccess) return err;
    attr_device = device;
  }
  decode_attention_kernel<T, CT, DP, kSlots>
      <<<dim3(a.n_split, a.K, a.B), kThreads, smem_bytes<T, DP>(a.G), a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const CT*>(a.k), static_cast<const CT*>(a.v),
          a.kv_len, a.slot_pos, a.k_scale, a.v_scale, static_cast<T*>(a.out), a.G, a.T_len, a.D,
          a.scale, a.window, a.vec, a.st, a.part_ml, a.part_acc, a.counters, a.lse);
  return cudaGetLastError();
}

template <typename T, typename CT, bool kSlots>
cudaError_t launch_dp(const Args& a) {
  if (a.D <= 32) return launch<T, CT, 32, kSlots>(a);
  if (a.D <= 64) return launch<T, CT, 64, kSlots>(a);
  if (a.D <= 128) return launch<T, CT, 128, kSlots>(a);
  return launch<T, CT, 256, kSlots>(a);
}

template <typename T>
cudaError_t launch_dtype(const Args& a) {
  const bool quant = a.k_scale != nullptr, slots = a.slot_pos != nullptr;
  if (quant)
    return slots ? launch_dp<T, int8_t, true>(a) : launch_dp<T, int8_t, false>(a);
  return slots ? launch_dp<T, T, true>(a) : launch_dp<T, T, false>(a);
}

template <typename CT, int DP, bool kSlots>
cudaError_t launch_tc(const Args& a) {
  static int attr_device = -1;  // the shared-memory ceiling is per device
  auto kernel = decode_attention_tc_kernel<CT, DP, kSlots>;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != attr_device) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tc_smem_bytes<DP>());
    if (err != cudaSuccess) return err;
    attr_device = device;
  }
  // a bf16 cache by the tensor-map copies when 16-byte aligned (`vec`) and
  // a tensor map describes it
  CUtensorMap tmk = {}, tmv = {};
  const int tma = !std::is_same<CT, int8_t>::value && a.vec &&
                  tile_map(&tmk, a.k, a.B, a.K, a.T_len, a.D, a.st.k, kTcKeys) &&
                  tile_map(&tmv, a.v, a.B, a.K, a.T_len, a.D, a.st.v, kTcKeys);
  kernel<<<dim3(a.n_split, a.K, a.B), kThreads, tc_smem_bytes<DP>(), a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const CT*>(a.k),
      static_cast<const CT*>(a.v), a.kv_len, a.slot_pos, a.k_scale, a.v_scale,
      static_cast<__nv_bfloat16*>(a.out), a.G, a.T_len, a.D, a.scale, a.window, tma, a.st,
      a.part_ml, a.part_acc, a.counters, a.lse, tmk, tmv);
  return cudaGetLastError();
}

template <typename CT, bool kSlots>
cudaError_t launch_tc_dp(const Args& a) {
  if (a.D <= 32) return launch_tc<CT, 32, kSlots>(a);
  if (a.D <= 64) return launch_tc<CT, 64, kSlots>(a);
  if (a.D <= 128) return launch_tc<CT, 128, kSlots>(a);
  return launch_tc<CT, 256, kSlots>(a);
}

// bf16 q: the tensor-core kernel, over a bf16 cache or int8 codes
cudaError_t launch_bf16(const Args& a) {
  const bool quant = a.k_scale != nullptr, slots = a.slot_pos != nullptr;
  if (quant)
    return slots ? launch_tc_dp<int8_t, true>(a) : launch_tc_dp<int8_t, false>(a);
  return slots ? launch_tc_dp<__nv_bfloat16, true>(a) : launch_tc_dp<__nv_bfloat16, false>(a);
}

template <typename Kernel>
int occupancy_of(Kernel kernel, size_t smem, int* ctas_per_sm, int* smem_bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, kThreads, smem);
  *smem_bytes = (int)smem;
  return (int)err;
}

// which: bit 2 bf16 q (the tensor-core kernel), bit 1 int8 codes, bit 0 slots
template <int DP>
int occupancy_dp(int which, int* c, int* m) {
  using bf16 = __nv_bfloat16;
  const size_t f = smem_bytes<float, DP>(kMaxG), t = tc_smem_bytes<DP>();
  switch (which) {
    case 0: return occupancy_of(decode_attention_kernel<float, float, DP, false>, f, c, m);
    case 1: return occupancy_of(decode_attention_kernel<float, float, DP, true>, f, c, m);
    case 2: return occupancy_of(decode_attention_kernel<float, int8_t, DP, false>, f, c, m);
    case 3: return occupancy_of(decode_attention_kernel<float, int8_t, DP, true>, f, c, m);
    case 4: return occupancy_of(decode_attention_tc_kernel<bf16, DP, false>, t, c, m);
    case 5: return occupancy_of(decode_attention_tc_kernel<bf16, DP, true>, t, c, m);
    case 6: return occupancy_of(decode_attention_tc_kernel<int8_t, DP, false>, t, c, m);
    default: return occupancy_of(decode_attention_tc_kernel<int8_t, DP, true>, t, c, m);
  }
}

}  // namespace

extern "C" {

// Largest grouped-query count, head dimension and split count the kernel
// takes.
int decode_attention_max_group() { return kMaxG; }
int decode_attention_max_head_dim() { return 256; }
int decode_attention_max_splits() { return kMaxSplits; }

// Launch on `stream`.  dtype 0 = f32, 1 = bf16 (q and out; k and v too
// unless k_scale is given).  `strides` holds 20 element strides: q (b, k,
// g), k (b, k, t), v (b, k, t), out (b, k, g), slot_pos (b, t), k_scale (b,
// k, t), v_scale (b, k, t); those of an absent operand are ignored.
// slot_pos (B, T) int32 or null selects the slot-position variant; k_scale
// and v_scale (both or neither) select int8 codes in k and v.  `vec` = 1
// when k and v may be copied by 16-byte cp.async (D * element size, the
// b/k/t strides in bytes and both bases are 16-byte multiples; unused for
// int8 codes).  With n_split > 1: part_ml holds B*K*n_split*G*2 and part_acc
// B*K*n_split*G*DP floats (DP = D rounded up to 32, 64, 128 or 256), and
// counters B*K ints that are 0 before the call and 0 again after it.
// lse, when not null, receives B*K*G floats (contiguous (B, K, G)): each
// row's log-sum-exp of its scaled scores, -inf where it has no allowed key.
// Returns the CUDA error code (0 on success).
int decode_attention_launch(int dtype, const void* q, const void* k, const void* v,
                            const int* kv_len, const int* slot_pos, const float* k_scale,
                            const float* v_scale, void* out, int B, int K, int G,
                            int T_len, int D, float scale, int window, int n_split,
                            int vec, const long long* strides, float* part_ml,
                            float* part_acc, int* counters, float* lse, void* stream) {
  if (B < 0 || K < 0 || G < 0 || G > kMaxG || T_len < 1 || D < 1 || D > 256 ||
      window < 0 || n_split < 1 || n_split > kMaxSplits || strides == nullptr ||
      (dtype != 0 && dtype != 1) || ((k_scale == nullptr) != (v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0 || G == 0) return 0;
  if (K > 65535 || B > 65535 || kv_len == nullptr ||
      (n_split > 1 && (part_ml == nullptr || part_acc == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, kv_len, slot_pos, k_scale, v_scale, out, B, K, G, T_len, D, scale,
         window, n_split, k_scale != nullptr ? 0 : vec, Strides{}, part_ml, part_acc,
         counters, lse, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
    a.st.o[i] = strides[9 + i];
    a.st.ks[i] = strides[14 + i];
    a.st.vs[i] = strides[17 + i];
  }
  a.st.sp[0] = strides[12];
  a.st.sp[1] = strides[13];
  const cudaError_t err = dtype == 0 ? launch_dtype<float>(a) : launch_bf16(a);
  return (int)err;
}

// Resident CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
// dynamic shared memory of the instance a launch of dtype (q's), cache kind
// and head dim D takes (the f32 kernel's for G = 16).  Returns the CUDA
// error code.
int decode_attention_occupancy(int dtype, int quant, int slots, int D, int* ctas_per_sm,
                               int* smem_bytes) {
  if (D < 1 || D > 256 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const int dp = D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
  const int which = (dtype << 2) | ((quant != 0) << 1) | (slots != 0);
  switch (dp) {
    case 32: return occupancy_dp<32>(which, ctas_per_sm, smem_bytes);
    case 64: return occupancy_dp<64>(which, ctas_per_sm, smem_bytes);
    case 128: return occupancy_dp<128>(which, ctas_per_sm, smem_bytes);
    default: return occupancy_dp<256>(which, ctas_per_sm, smem_bytes);
  }
}

}  // extern "C"
