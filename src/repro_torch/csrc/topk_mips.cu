// Exact namespace-masked top-k maximum-inner-product search for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel_masked` + `_merge_topk` of
// src/repro/kernels/topk_mips.py (pallas_call at topk_mips.py:227): for each
// query q, the exact top-k of q . bank[r] over the rows r < n_valid whose
// namespace label equals the query's (bank_ns[r] == q_ns[q]).  Ranking key
// is (score desc, row asc), so an exact tie goes to the lower row; a slot
// that no live row fills is (NEG_INF = -2e38, -1).
//
// What bounds it: the bank read (N*D*4 bytes) and the plain-FP32 product
// (2*Q*N*D flops).  At the main path's shape (Q=64, N=2^20, D=256) that is
// 1.07 GB -> 0.32 ms at 3.35 TB/s and 34.4 GFLOP -> 0.51 ms at 67 TFLOP/s
// of non-tensor-core FP32, so the flops bound it.  TF32 tensor cores would
// be 7x faster but keep ~3 decimal digits, which breaks the rtol=1e-5
// parity the reference holds, so the product stays in FP32 FMA.
//
// Design (not the TPU grid: the Pallas grid walks the bank in order with
// one program per 128-query tile, which at Q <= 64 keeps one core busy):
//   pass 1  the bank's live prefix is split into row chunks, one CTA per
//           (chunk, 64-query tile), enough CTAs to fill every SM.  A CTA
//           streams its chunk in 64-row tiles, scores each tile against
//           the query tile with a register-tiled FP32 FMA product (each
//           thread owns a 4x4 block of scores), masks it, and offers the
//           survivors to a per-query sorted top-k list in shared memory.
//   pass 2  one warp per query merges the chunks' sorted lists in chunk
//           order into the final list and writes the sentinels.
// Every score is a single fmaf chain over d = 0..D-1 in order, whatever
// tile or CTA its row lands in, so identical rows score bit-identically and
// the tie rule is exact.
//
// Selection: a query's list holds exactly k entries sorted by the ranking
// key (empty slots are (-inf, INT_MAX)); its threshold is the k-th score.
// Candidates arrive 32 at a time, one per lane.  Because every stream is
// offered in ascending row order among equal scores (pass 1: rows ascend;
// pass 2: chunks ascend and each chunk list is sorted), a candidate whose
// score merely equals the threshold ranks after the k-th entry and is
// dropped, so admission is `score > threshold`.  Admitted candidates are
// bitonic-sorted in registers and merged into the list by co-ranking (a
// binary search per element), which needs no padding to a power of two.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 64;            // queries per CTA tile
constexpr int kBN = 64;            // bank rows per tile
constexpr int kDK = 32;            // depth step staged in shared memory
constexpr int kStride = kQT + 4;   // row stride of the staged tiles (16 B aligned)
constexpr int kMaxK = 256;
constexpr int kPadRow = 0x7fffffff;
constexpr float kNegInf = -2.0e38f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kQT == kBN, "the 16x16 thread grid assumes square tiles");
static_assert(kQT % kWarps == 0, "queries are dealt evenly to warps");

__device__ __forceinline__ bool ranks_before(float sa, int ra, float sb, int rb) {
  return sa > sb || (sa == sb && ra < rb);
}

// Bitonic sort of one (score, row) pair per lane into ranking order
// (lane 0 holds the best).
__device__ __forceinline__ void warp_sort32(float& s, int& r) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float os = __shfl_xor_sync(kFull, s, stride);
      const int orow = __shfl_xor_sync(kFull, r, stride);
      const bool lower = (lane & stride) == 0;
      const bool ascending = (lane & size) == 0;
      const bool other_first = ranks_before(os, orow, s, r);
      const bool take = (lower == ascending) ? other_first : !other_first;
      if (take) {
        s = os;
        r = orow;
      }
    }
  }
}

// Offer one candidate per lane to the sorted list (ls, lr) of length k.
// `ok` false means the lane has no candidate.  scr_* (k entries) and nw_*
// (32 entries) are this warp's scratch.  Warp-collective.
__device__ void offer(float s, int r, bool ok, float* ls, int* lr, int k,
                      float* scr_s, int* scr_r, float* nw_s, int* nw_r) {
  const int lane = threadIdx.x & 31;
  const float thr = ls[k - 1];
  const bool take = ok && (s > thr);
  const unsigned mask = __ballot_sync(kFull, take);
  if (mask == 0u) return;
  const int cnt = __popc(mask);
  if (!take) {
    s = -CUDART_INF_F;
    r = kPadRow;
  }
  warp_sort32(s, r);
  nw_s[lane] = s;
  nw_r[lane] = r;
  __syncwarp();
  if (lane < cnt) {
    // list entries ranking before this candidate
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ranks_before(ls[mid], lr[mid], s, r)) lo = mid + 1; else hi = mid;
    }
    const int pos = lane + lo;
    if (pos < k) {
      scr_s[pos] = s;
      scr_r[pos] = r;
    }
  }
  for (int i = lane; i < k; i += 32) {
    const float bs = ls[i];
    const int br = lr[i];
    // admitted candidates ranking before list entry i
    int lo = 0, hi = cnt;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ranks_before(nw_s[mid], nw_r[mid], bs, br)) lo = mid + 1; else hi = mid;
    }
    const int pos = i + lo;
    if (pos < k) {
      scr_s[pos] = bs;
      scr_r[pos] = br;
    }
  }
  __syncwarp();
  for (int i = lane; i < k; i += 32) {
    ls[i] = scr_s[i];
    lr[i] = scr_r[i];
  }
  __syncwarp();
}

size_t partial_smem_bytes(int k) {
  return sizeof(float) * (2 * kDK * kStride + kQT * (kBN + 1)) +
         (sizeof(float) + sizeof(int)) * (size_t)(kQT * k + kWarps * k + kWarps * 32) +
         sizeof(int) * (kQT + kBN);
}

// at most 34 KB (k = kMaxK), under the default dynamic shared-memory ceiling
size_t merge_smem_bytes(int k) {
  return (sizeof(float) + sizeof(int)) * (size_t)(2 * kWarps * k + kWarps * 32);
}

__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ bank,
                    const int* __restrict__ q_ns, const int* __restrict__ bank_ns,
                    int Q, int D, int n_valid, int k, int rows_per_chunk,
                    int n_chunks, float* __restrict__ part_s,
                    int* __restrict__ part_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);          // [kDK][kStride] queries
  float* Bs = As + kDK * kStride;                      // [kDK][kStride] bank rows
  float* S = Bs + kDK * kStride;                       // [kQT][kBN + 1] scores
  float* ls = S + kQT * (kBN + 1);                     // [kQT][k] list scores
  int* lr = reinterpret_cast<int*>(ls + kQT * k);      // [kQT][k] list rows
  float* scr_s = reinterpret_cast<float*>(lr + kQT * k);  // [kWarps][k]
  int* scr_r = reinterpret_cast<int*>(scr_s + kWarps * k);
  float* nw_s = reinterpret_cast<float*>(scr_r + kWarps * k);  // [kWarps][32]
  int* nw_r = reinterpret_cast<int*>(nw_s + kWarps * 32);
  int* qns_t = nw_r + kWarps * 32;                     // [kQT]
  int* bns_t = qns_t + kQT;                            // [kBN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * kQT;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(n_valid, row_begin + rows_per_chunk);
  const int tx = tid & 15;   // bank rows tx*4 .. tx*4+3 of the tile
  const int ty = tid >> 4;   // queries   ty*4 .. ty*4+3 of the tile

  for (int i = tid; i < kQT * k; i += kThreads) {
    ls[i] = -CUDART_INF_F;
    lr[i] = kPadRow;
  }
  for (int i = tid; i < kQT; i += kThreads) qns_t[i] = (q0 + i < Q) ? q_ns[q0 + i] : 0;
  __syncthreads();

  for (int r0 = row_begin; r0 < row_end; r0 += kBN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kDK) {
      for (int e = tid; e < kQT * kDK; e += kThreads) {
        const int qi = e / kDK, dd = e % kDK;
        const int gq = q0 + qi, gd = d0 + dd;
        As[dd * kStride + qi] = (gq < Q && gd < D) ? q[(size_t)gq * D + gd] : 0.f;
      }
      for (int e = tid; e < kBN * kDK; e += kThreads) {
        const int ri = e / kDK, dd = e % kDK;
        const int gr = r0 + ri, gd = d0 + dd;
        Bs[dd * kStride + ri] = (gr < row_end && gd < D) ? bank[(size_t)gr * D + gd] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < kDK; ++dd) {
        const float4 a = *reinterpret_cast<const float4*>(&As[dd * kStride + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[dd * kStride + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) S[(ty * 4 + i) * (kBN + 1) + tx * 4 + j] = acc[i][j];
    for (int i = tid; i < kBN; i += kThreads) {
      const int gr = r0 + i;
      bns_t[i] = (gr < row_end) ? bank_ns[gr] : 0;
    }
    __syncthreads();

    for (int qi = warp; qi < kQT; qi += kWarps) {
      if (q0 + qi >= Q) break;
      float* qls = ls + qi * k;
      int* qlr = lr + qi * k;
#pragma unroll
      for (int h = 0; h < kBN; h += 32) {
        const int ri = h + lane;
        const int row = r0 + ri;
        const bool ok = row < row_end && bns_t[ri] == qns_t[qi];
        offer(S[qi * (kBN + 1) + ri], row, ok, qls, qlr, k, scr_s + warp * k,
              scr_r + warp * k, nw_s + warp * 32, nw_r + warp * 32);
      }
    }
    __syncthreads();
  }

  for (int qi = warp; qi < kQT; qi += kWarps) {
    if (q0 + qi >= Q) break;
    const size_t base = ((size_t)(q0 + qi) * n_chunks + chunk) * k;
    for (int i = lane; i < k; i += 32) {
      part_s[base + i] = ls[qi * k + i];
      part_r[base + i] = lr[qi * k + i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_r,
                  int Q, int k, int n_chunks, float* __restrict__ out_s,
                  int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* ls = reinterpret_cast<float*>(smem) + warp * k;
  int* lr = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + kWarps * k) + warp * k;
  float* scr_s = reinterpret_cast<float*>(smem) + 2 * kWarps * k + warp * k;
  int* scr_r = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + 3 * kWarps * k) + warp * k;
  float* nw_s = reinterpret_cast<float*>(smem) + 4 * kWarps * k + warp * 32;
  int* nw_r = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + 4 * kWarps * k + kWarps * 32) + warp * 32;

  const int qq = blockIdx.x * kWarps + warp;
  if (qq >= Q) return;   // warp-uniform; this kernel has no block barrier
  for (int i = lane; i < k; i += 32) {
    ls[i] = -CUDART_INF_F;
    lr[i] = kPadRow;
  }
  __syncwarp();
  for (int c = 0; c < n_chunks; ++c) {
    const float* cs = part_s + ((size_t)qq * n_chunks + c) * k;
    const int* cr = part_r + ((size_t)qq * n_chunks + c) * k;
    for (int g = 0; g < k; g += 32) {
      const int i = g + lane;
      const bool in = i < k;
      const float s = in ? cs[i] : -CUDART_INF_F;
      const int r = in ? cr[i] : kPadRow;
      offer(s, r, in, ls, lr, k, scr_s, scr_r, nw_s, nw_r);
      // a chunk list is sorted: once its smallest offered score cannot
      // pass the threshold, nothing later in it can
      const float s_last = __shfl_sync(kFull, s, min(31, k - 1 - g));
      if (!(s_last > ls[k - 1])) break;
    }
  }
  for (int i = lane; i < k; i += 32) {
    const bool live = lr[i] != kPadRow;
    out_s[(size_t)qq * k + i] = live ? ls[i] : kNegInf;
    out_i[(size_t)qq * k + i] = live ? lr[i] : -1;
  }
}

}  // namespace

extern "C" {

// Launch both passes on `stream`.  part_s/part_r hold Q * n_chunks * k
// entries; rows_per_chunk is a multiple of the tile height.  Returns the
// CUDA error code of the launches (0 on success).
int topk_mips_masked_launch(const float* q, const float* bank, const int* q_ns,
                            const int* bank_ns, int Q, int D, int n_valid, int k,
                            int n_chunks, int rows_per_chunk, float* part_s,
                            int* part_r, float* out_s, int* out_i, void* stream) {
  if (Q < 0 || D < 0 || n_valid < 0 || k < 1 || k > kMaxK || n_chunks < 0 ||
      (n_chunks > 0 && (rows_per_chunk <= 0 || rows_per_chunk % kBN != 0)))
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Pass 1 takes more dynamic shared memory than the default 48 KB ceiling
  // (pass 2 stays below it).  Raise the ceiling on the first launch on a
  // device, to what k = kMaxK needs, which covers every k.
  static int smem_device = -1;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != smem_device) {
    err = cudaFuncSetAttribute(topk_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)partial_smem_bytes(kMaxK));
    if (err != cudaSuccess) return (int)err;
    smem_device = device;
  }
  if (n_chunks > 0) {
    dim3 grid(n_chunks, (Q + kQT - 1) / kQT);
    topk_partial_kernel<<<grid, kThreads, partial_smem_bytes(k), st>>>(
        q, bank, q_ns, bank_ns, Q, D, n_valid, k, rows_per_chunk, n_chunks,
        part_s, part_r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  topk_merge_kernel<<<(Q + kWarps - 1) / kWarps, kThreads, merge_smem_bytes(k), st>>>(
      part_s, part_r, Q, k, n_chunks, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
