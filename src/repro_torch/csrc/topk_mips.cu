// Exact top-k maximum-inner-product search for Hopper: the four Pallas TPU
// kernels of src/repro/kernels/topk_mips.py as two CUDA designs, each a
// template over <kMasked, kQuant>, behind one C entry point.
//
//   K1 <true,  false>  `_kernel_masked` + `_merge_topk`  (pallas_call :227)
//   K2 <true,  true>   `_kernel_quant_masked`            (pallas_call :227)
//   K3 <false, false>  `_kernel`                         (pallas_call :210)
//   K4 <false, true>   `_kernel_quant`                   (pallas_call :210)
//
// Routing: K3 and K4 at every k, and K1 and K2 at kMaxK < k <= kScanMaxK,
// run the scan kernel (topk_scan_kernel + topk_merge_lists_kernel, below).
// K1 and K2 at k <= kMaxK = 256 -- every call on the service's path -- run
// the partial kernel (topk_partial_kernel + topk_merge_kernel).
//
// For each query q: the exact top-k of score(q, r) over the rows r < n_valid
// (masked: only rows whose label equals the query's, bank_ns[r] == q_ns[q]).
// f32 bank: score = q . bank[r].  int8 bank with per-row f32 scales (quant):
// score = (q . float(codes[r])) * scales[r] -- the codes are contracted as
// exact floats and the sum is multiplied by the scale afterwards, the
// reference's order (dequantizing the row first would round differently).
// Ranking key is (score desc, row asc), so an exact tie goes to the lower
// row; a slot that no live row fills is (NEG_INF = -2e38, -1).
//
// What bounds it: the plain-FP32 product, 2*Q*N*D flops, at the main path's
// shapes.  Q=64, N=2^20, D=256: 34.4 GFLOP -> 0.51 ms at 67 TFLOP/s of
// non-tensor-core FP32, against a bank read of 1.07 GB -> 0.32 ms at 3.35
// TB/s for f32 and 0.28 GB -> 0.08 ms for int8 codes: the int8 bank moves a
// quarter of the bytes but does the same operations, so K2 and K4 are
// bounded by the operations too.  TF32 (or int8) tensor cores would be
// faster but keep ~3 decimal digits of the query, which breaks the
// rtol=1e-5 parity the reference holds, so the product stays in FP32 FMA.
// Every score is a single fmaf chain over d = 0..D-1 in order (then one
// multiply by the row's scale), whatever tile or CTA its row lands in, so
// identical rows score bit-identically and the tie rule is exact.
//
// The partial kernel (not the TPU grid: the Pallas grid walks the bank in
// order with one program per 128-query tile, which at Q <= 64 keeps one
// core busy):
//   pass 1  the bank's live prefix is split into row chunks, one CTA per
//           (chunk, 64-query tile), enough CTAs to fill every SM.  A CTA
//           streams its chunk in 64-row tiles, stages each tile into shared
//           memory as f32 (int8 codes convert exactly, read with 16-byte
//           vector loads: a D = 256 row is 256 B), scores the tile against
//           the query tile with a register-tiled FP32 FMA product (each
//           thread owns a 4x4 block of scores), scales and masks it, and
//           offers the survivors to a per-query sorted top-k list in shared
//           memory.
//   pass 2  one warp per query merges the chunks' sorted lists in chunk
//           order into the final list and writes the sentinels.
//
// Its selection: a query's list holds exactly k entries sorted by the ranking
// key (empty slots are (-inf, INT_MAX)); its threshold is the k-th score.
// Candidates arrive 32 at a time, one per lane.  Because every stream is
// offered in ascending row order among equal scores (pass 1: rows ascend;
// pass 2: chunks ascend and each chunk list is sorted), a candidate whose
// score merely equals the threshold ranks after the k-th entry and is
// dropped, so admission is `score > threshold`.  Admitted candidates are
// bitonic-sorted in registers and merged into the list by co-ranking (a
// binary search per element), which needs no padding to a power of two.
// That costs O(k) per admitting 32-row batch: cheap when masked (a query's
// namespace owns few of a chunk's rows), too dear unmasked, where the scan
// kernel takes over.

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
constexpr int kVec = 16;           // int8 codes per 16-byte vector load
constexpr int kMaxK = 256;
constexpr int kPadRow = 0x7fffffff;
constexpr float kNegInf = -2.0e38f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kQT == kBN, "the 16x16 thread grid assumes square tiles");
static_assert(kQT % kWarps == 0, "queries are dealt evenly to warps");
static_assert(kDK % kVec == 0, "a depth step is whole vector loads");

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

// Pass 1's dynamic shared memory: staged tiles, the score tile, the
// per-query lists and scratch, and the tile's labels and scales.  At most
// 180 KB (k = kMaxK), so one CTA fits on an SM at k = 256 and two at
// k <= 128 (kernels/topk_mips.py mirrors this to plan the grid).
size_t partial_smem_bytes(int k) {
  return sizeof(float) * (2 * kDK * kStride + kQT * (kBN + 1)) +
         (sizeof(float) + sizeof(int)) * (size_t)(kQT * k + kWarps * k + kWarps * 32) +
         sizeof(int) * (kQT + kBN) + sizeof(float) * kBN;
}

// at most 34 KB (k = kMaxK), under the default dynamic shared-memory ceiling
size_t merge_smem_bytes(int k) {
  return (sizeof(float) + sizeof(int)) * (size_t)(2 * kWarps * k + kWarps * 32);
}

// kMasked: rows must carry the query's label.  kQuant: `bank` is int8 codes
// with per-row `scales`; `vec16` says every row's codes can be read with
// aligned 16-byte loads (D % 16 == 0 and a 16-byte aligned bank).
template <bool kMasked, bool kQuant>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const float* __restrict__ q, const void* __restrict__ bank_v,
                    const float* __restrict__ scales,
                    const int* __restrict__ q_ns, const int* __restrict__ bank_ns,
                    int Q, int D, int n_valid, int k, int rows_per_chunk,
                    int n_chunks, bool vec16, float* __restrict__ part_s,
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
  float* scl_t = reinterpret_cast<float*>(bns_t + kBN);  // [kBN]

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
  if constexpr (kMasked) {
    for (int i = tid; i < kQT; i += kThreads) qns_t[i] = (q0 + i < Q) ? q_ns[q0 + i] : 0;
  }
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
      if constexpr (kQuant) {
        const int8_t* bank = static_cast<const int8_t*>(bank_v);
        if (vec16) {
          // two 16-byte loads per row and depth step; neighbouring threads
          // read the two halves of one row's 32 codes
          for (int e = tid; e < kBN * (kDK / kVec); e += kThreads) {
            const int ri = e / (kDK / kVec), c = e % (kDK / kVec);
            const int gr = r0 + ri, gd = d0 + c * kVec;
            int4 v = make_int4(0, 0, 0, 0);
            if (gr < row_end && gd < D)
              v = *reinterpret_cast<const int4*>(bank + (size_t)gr * D + gd);
            const unsigned w[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z,
                                   (unsigned)v.w};
#pragma unroll
            for (int t = 0; t < kVec; ++t)
              Bs[(c * kVec + t) * kStride + ri] =
                  static_cast<float>(static_cast<int8_t>(w[t >> 2] >> (8 * (t & 3))));
          }
        } else {
          for (int e = tid; e < kBN * kDK; e += kThreads) {
            const int ri = e / kDK, dd = e % kDK;
            const int gr = r0 + ri, gd = d0 + dd;
            Bs[dd * kStride + ri] =
                (gr < row_end && gd < D) ? static_cast<float>(bank[(size_t)gr * D + gd]) : 0.f;
          }
        }
      } else {
        const float* bank = static_cast<const float*>(bank_v);
        for (int e = tid; e < kBN * kDK; e += kThreads) {
          const int ri = e / kDK, dd = e % kDK;
          const int gr = r0 + ri, gd = d0 + dd;
          Bs[dd * kStride + ri] = (gr < row_end && gd < D) ? bank[(size_t)gr * D + gd] : 0.f;
        }
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
      if constexpr (kMasked) bns_t[i] = (gr < row_end) ? bank_ns[gr] : 0;
      if constexpr (kQuant) scl_t[i] = (gr < row_end) ? scales[gr] : 0.f;
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
        bool ok = row < row_end;
        if constexpr (kMasked) ok = ok && bns_t[ri] == qns_t[qi];
        float s = S[qi * (kBN + 1) + ri];
        if constexpr (kQuant) s = s * scl_t[ri];   // after the sum, as the reference
        offer(s, row, ok, qls, qlr, k, scr_s + warp * k, scr_r + warp * k,
              nw_s + warp * 32, nw_r + warp * 32);
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

template <bool kMasked, bool kQuant>
cudaError_t raise_smem_ceiling() {
  return cudaFuncSetAttribute(topk_partial_kernel<kMasked, kQuant>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)partial_smem_bytes(kMaxK));
}

template <bool kMasked, bool kQuant>
void launch_partial(dim3 grid, size_t smem, cudaStream_t st, const float* q,
                    const void* bank, const float* scales, const int* q_ns,
                    const int* bank_ns, int Q, int D, int n_valid, int k,
                    int rows_per_chunk, int n_chunks, bool vec16, float* part_s,
                    int* part_r) {
  topk_partial_kernel<kMasked, kQuant><<<grid, kThreads, smem, st>>>(
      q, bank, scales, q_ns, bank_ns, Q, D, n_valid, k, rows_per_chunk,
      n_chunks, vec16, part_s, part_r);
}

// ---------------------------------------------------------------------------
// The scan kernel: K3 and K4 at every k, K1 and K2 at kMaxK < k <= kScanMaxK.
//
// pass 1  topk_scan_kernel<kMasked, kQuant, kQW>: one CTA per (chunk, query
//         tile of 8*kQW queries); the live prefix's 256-row tiles are split
//         evenly over the chunks.  Warp w owns queries w*kQW .. w*kQW+kQW-1
//         of the tile for the whole chunk: their scores, thresholds,
//         candidate buffers and lists, so selection needs no block barrier.
//         Lane l owns rows l + 32 j (j < 8) of each tile, a kQW x 8 register
//         tile of scores, fed per 4 depths by 8 + kQW 16-byte shared loads
//         for 32 kQW FMAs.  The bank streams through a 3-stage ring of
//         16-deep slices (16-byte cp.async, zero-filled past the edges),
//         stored [row][d] with a 20-float row stride (conflict-free 16-byte
//         reads); int8 codes land raw and are converted to f32 once per
//         element, smem -> smem, before the product.  The query tile stays
//         in shared memory for the whole CTA when it fits (`resident`),
//         otherwise its 16-deep slice rides in each ring stage.  The query
//         tile is the widest (64, 32, 16, 8) whose lists, buffers and ring
//         fit in a block's 227 KB: 64 at the main shapes (K3 f32 k = 64,
//         K4 int8 k = 256), 32 for f32 at k = 256, 8 at k = 2048.
// pass 2  topk_merge_lists_kernel: one CTA per query; warp w merges chunk
//         lists w, w+8, ... into its own list, then the 8 lists merge in a
//         tree of three rounds.
//
// Selection (pass 1).  A tile's score s of row r for query i is a candidate
// iff r < row_end, the labels match (masked), s > thr[i] (the k-th score of
// the query's merged list, -inf until it is full) and s >= the query's
// floor (below).  Few candidates in a tile (< kBuf / 2) are appended to the
// query's buffer (ballot + popc); many -- a chunk's first tiles -- are
// sorted as a whole tile in registers and merged into the list at once.  A
// buffer past half full posts a joint flush: at the next tile every warp
// sorts and merges all its buffers, so the merges of all warps overlap
// between two barriers instead of each stalling the CTA in turn.  The
// selection each tile runs is short code; the rest (`admit`, `sort_merge`,
// `merge_sorted`) is out of line, so the tile loop stays in the
// instruction cache.
//
// Dropping a score that merely EQUALS thr[i] is exact: tiles run through a
// chunk in ascending row order, so every entry of the merged list has a
// lower row than the candidate, which ranks after the k-th entry.  The
// merge pass has no such order (warps take interleaved chunks), so it
// admits by the full key (score desc, row asc).
//
// Floors.  floor_key[q] holds a score that k live rows reach, so a row
// scoring below it cannot enter the final top-k (one that equals it may,
// by row, and is kept).  Every chunk whose list is full raises it to its
// k-th score (atomicMax on an order-preserving key).  When chunks hold at
// least kSampleRatio tiles, a sample pass first scans the last tile of
// each chunk (one a CTA) and merges them exactly: their k-th score is the
// floor the main pass starts from, so in a bank of random order only
// ~k * rows / (256 n_chunks) rows of each chunk pass it, and in a bank
// whose scores rise with the row almost none but the last chunk's.
// ---------------------------------------------------------------------------

constexpr int kScanMaxK = 2048;
constexpr int kTileRows = 256;      // bank rows per tile: lane l owns l + 32 j
constexpr int kRowsPerLane = kTileRows / 32;
constexpr int kSlice = 16;          // depth of one ring stage
constexpr int kSliceStride = kSlice + 4;   // floats per staged row
constexpr int kStages = 3;
constexpr int kBuf = 64;            // candidate buffer of one query (pow2)
constexpr int kSeg = 256;           // merge pass: list entries per admission
constexpr int kSmemMax = 232448;    // dynamic shared memory a block can use
constexpr int kScanWidths[4] = {8, 4, 2, 1};   // kQW, widest first
constexpr int kSampleRatio = 4;     // sample pass when chunks hold >= 4 tiles

static_assert(kTileRows == kThreads, "int8 staging gives each thread a row");
static_assert(kBuf % 32 == 0 && (kBuf & (kBuf - 1)) == 0, "kBuf is a pow2 of warps");
static_assert(kSeg % 32 == 0, "kSeg is whole warps");

// Scores as unsigned keys in the same order (0 is below every score), so
// a query's score floor can be raised with atomicMax.
__device__ __forceinline__ unsigned score_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_score(unsigned u) {
  if (u == 0u) return -CUDART_INF_F;
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__host__ __device__ inline int padded_depth(int D) {
  return (D + kSlice - 1) / kSlice * kSlice + 4;
}

// Pass 1's dynamic shared memory for a query tile of qt queries: the ring
// (bank slice, and query slice unless resident),
// the int8 conversion tile, the resident queries, then the lists, the
// candidate buffers and a tile's worth of scratch a warp (8 bytes an entry).
size_t scan_smem_bytes(int k, bool quant, int D, int qt, bool resident) {
  const size_t bank_stage = quant ? (size_t)kTileRows * kSlice
                                  : sizeof(float) * kTileRows * kSliceStride;
  const size_t q_stage = resident ? 0 : sizeof(float) * qt * kSliceStride;
  const size_t conv = quant ? sizeof(float) * kTileRows * kSliceStride : 0;
  const size_t qres = resident ? sizeof(float) * qt * padded_depth(D) : 0;
  return kStages * (bank_stage + q_stage) + conv + qres +
         (sizeof(float) + sizeof(int)) * ((size_t)qt * (k + kBuf) + kWarps * kTileRows) +
         2 * sizeof(int);
}

// The widest warp query width kQW whose tile fits, and whether its queries
// can stay resident.  0 if none fits (never for k <= kScanMaxK).
int scan_width(int k, bool quant, int D, bool* resident) {
  for (int qw : kScanWidths) {
    if (scan_smem_bytes(k, quant, D, 8 * qw, false) <= (size_t)kSmemMax) {
      *resident = scan_smem_bytes(k, quant, D, 8 * qw, true) <= (size_t)kSmemMax;
      return qw;
    }
  }
  return 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;   // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// For each of kN keys, the number of entries of the sorted (as, ar)[0, n)
// that rank before it (n >= 1): a branchless lower bound whose steps
// depend on n alone, so the kN searches' loads overlap.
template <int kN>
__device__ __forceinline__ void lower_bounds(const float* as, const int* ar, int n,
                                             const float (&ks)[kN], const int (&kr)[kN],
                                             int (&out)[kN]) {
#pragma unroll
  for (int t = 0; t < kN; ++t) out[t] = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int t = 0; t < kN; ++t)
      if (ranks_before(as[out[t] + half], ar[out[t] + half], ks[t], kr[t])) out[t] += half;
    len -= half;
  }
#pragma unroll
  for (int t = 0; t < kN; ++t)
    out[t] += ranks_before(as[out[t]], ar[out[t]], ks[t], kr[t]) ? 1 : 0;
}

// Merge `cnt` (1 <= cnt <= 32 * kSlots) entries src, sorted by the ranking
// key, into the sorted list (ls, lr) of length k, in place; no src entry
// shares a row with a list entry.  Each src entry's new place is its index
// plus the list entries ranking before it; each list entry's is its index
// plus the src entries ranking before it.  List entries only move up, so
// they move in groups of 128 from the back, and the src entries are
// written last.  Once a group's first entry does not move, nothing below
// it does.  Warp-collective.
template <int kSlots>
__device__ __noinline__ void merge_sorted(float* ls, int* lr, int k, const float* ss,
                                          const int* sr, int cnt) {
  constexpr int kGroup = 4;
  const int lane = threadIdx.x & 31;
  float vs[kSlots];
  int vr[kSlots], pos[kSlots];
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    const int j = lane + 32 * t;
    vs[t] = j < cnt ? ss[j] : -CUDART_INF_F;
    vr[t] = j < cnt ? sr[j] : kPadRow;
  }
  lower_bounds<kSlots>(ls, lr, k, vs, vr, pos);
#pragma unroll
  for (int t = 0; t < kSlots; ++t) pos[t] = lane + 32 * t < cnt ? pos[t] + lane + 32 * t : k;
  for (int g0 = (k - 1) / (32 * kGroup) * (32 * kGroup); g0 >= 0; g0 -= 32 * kGroup) {
    float s[kGroup];
    int r[kGroup], c[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = g0 + 32 * u + lane;
      s[u] = i < k ? ls[i] : -CUDART_INF_F;
      r[u] = i < k ? lr[i] : kPadRow;
    }
    lower_bounds<kGroup>(ss, sr, cnt, s, r, c);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = g0 + 32 * u + lane;
      if (i < k && c[u] > 0 && i + c[u] < k) {
        ls[i + c[u]] = s[u];
        lr[i + c[u]] = r[u];
      }
    }
    __syncwarp();
    if (__shfl_sync(kFull, c[0], 0) == 0) break;
  }
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    if (pos[t] < k) {
      ls[pos[t]] = vs[t];
      lr[pos[t]] = vr[t];
    }
  }
  __syncwarp();
}

// Bitonic sort of 32*E (score, row) pairs, element e = 32 j + lane in
// (s[j], r[j]), into ranking order (element 0 the best).  Strides of 32 and
// more compare registers of one lane, smaller strides shuffle.  E is a
// power of two.  Warp-collective.
template <int E>
__device__ __forceinline__ void warp_sort_regs(float (&s)[E], int (&r)[E]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int js = stride / 32;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if (j & js) continue;
          const bool best_first = ((32 * j) & size) == 0;
          const int h = j | js;
          if (best_first ? ranks_before(s[h], r[h], s[j], r[j])
                         : ranks_before(s[j], r[j], s[h], r[h])) {
            const float ts = s[j];
            const int tr = r[j];
            s[j] = s[h];
            r[j] = r[h];
            s[h] = ts;
            r[h] = tr;
          }
        }
      } else {
        const bool lower = (lane & stride) == 0;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float os = __shfl_xor_sync(kFull, s[j], stride);
          const int orow = __shfl_xor_sync(kFull, r[j], stride);
          const bool best_first = ((32 * j + lane) & size) == 0;
          const bool other_first = ranks_before(os, orow, s[j], r[j]);
          if ((lower == best_first) ? other_first : !other_first) {
            s[j] = os;
            r[j] = orow;
          }
        }
      }
    }
  }
}

// Sort the first cnt (<= 32 E) entries of (ss, sr) in registers (the rest
// count as (-inf, kPadRow)), write the best n back in order and merge them
// into the sorted list (ls, lr).  Used for a query's candidate buffer and
// for a whole tile's candidates.  Warp-collective.
template <int E>
__device__ __noinline__ void sort_merge(float* ls, int* lr, int k, float* ss, int* sr,
                                        int cnt, int n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  float s[E];
  int r[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = 32 * j + lane;
    s[j] = e < cnt ? ss[e] : -CUDART_INF_F;
    r[j] = e < cnt ? sr[e] : kPadRow;
  }
  warp_sort_regs<E>(s, r);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = 32 * j + lane;
    if (e < n) {
      ss[e] = s[j];
      sr[e] = r[j];
    }
  }
  __syncwarp();
  merge_sorted<E>(ls, lr, k, ss, sr, n);
}

// After a merge: if the query's list is full and its k-th score rose
// above `old`, raise the query's global floor to it.  Warp-collective.
__device__ __forceinline__ void raise_floor(unsigned* floor_key, const float* ls,
                                            const int* lr, int k, float old) {
  if ((threadIdx.x & 31) == 0 && lr[k - 1] != kPadRow && ls[k - 1] > old)
    atomicMax(floor_key, score_key(ls[k - 1]));
}

// Admit one tile's c candidates of a query: ws[32 j + lane] holds the
// score of row r0 + 32 j + lane where it passed the query's threshold and
// mask, -inf elsewhere.  Many (c >= kBuf / 2): sort the whole tile and
// merge it into the list at once.  Few: append them to the query's buffer
// (cnt entries), merging the buffer first should it overflow.  Returns the
// buffer's new count.  Kept out of line, so the selection each tile runs
// is short code.  Warp-collective.
__device__ __noinline__ int admit(float* ls, int* lr, int k, float* bs, int* br, int cnt,
                                  float* ws, int* wr, int c, int r0) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (c >= kBuf / 2) {
    for (int e = lane; e < kTileRows; e += 32)
      wr[e] = ws[e] > -CUDART_INF_F ? r0 + e : kPadRow;
    sort_merge<kRowsPerLane>(ls, lr, k, ws, wr, kTileRows, min(c, k));
    return cnt;
  }
  float thr = ls[k - 1];
  for (int e = lane; e < kTileRows; e += 32) {
    const float s = ws[e];
    bool ok = s > thr;
    unsigned m = __ballot_sync(kFull, ok);
    if (m == 0u) continue;
    if (cnt + __popc(m) > kBuf) {
      sort_merge<kBuf / 32>(ls, lr, k, bs, br, cnt, cnt);
      cnt = 0;
      thr = ls[k - 1];
      ok = ok && s > thr;
      m = __ballot_sync(kFull, ok);
    }
    if (ok) {
      const int p = cnt + __popc(m & ((1u << lane) - 1u));
      bs[p] = s;
      br[p] = r0 + e;
    }
    cnt += __popc(m);
  }
  __syncwarp();
  return cnt;
}

// Merge pass: admit the entries of one sorted segment (len <= kSeg) that
// rank before the list's k-th entry -- a prefix, as the segment is sorted
// -- through scratch into the list.  Returns whether the whole segment was
// admitted (if not, nothing after it in its list can be).  Warp-collective.
__device__ __noinline__ bool admit_segment(float* ls, int* lr, int k, const float* src_s,
                                           const int* src_r, int len, float* scr_s,
                                           int* scr_r) {
  const int lane = threadIdx.x & 31;
  const float ts = ls[k - 1];
  const int tr = lr[k - 1];
  int n = 0;
  for (int b0 = 0; b0 < len; b0 += 32) {
    const int i = b0 + lane;
    const bool in = i < len;
    const float s = in ? src_s[i] : -CUDART_INF_F;
    const int r = in ? src_r[i] : kPadRow;
    const bool ok = in && ranks_before(s, r, ts, tr);
    const int c = __popc(__ballot_sync(kFull, ok));
    if (ok) {
      scr_s[n + lane] = s;
      scr_r[n + lane] = r;
    }
    n += c;
    if (c < 32) break;
  }
  __syncwarp();
  if (n > 0) merge_sorted<kSeg / 32>(ls, lr, k, scr_s, scr_r, n);
  return n == len;
}

// Issue the copies of one ring stage: the 256 x 16 bank slice at (r0, d0)
// and, unless the queries are resident, the query tile's slice.  `vec`: the
// bank's rows can be read in aligned 16-byte pieces (f32: D % 4 == 0; int8:
// D % 16 == 0); `qvec` the same for the queries.  Otherwise plain loads.
template <bool kQuant>
__device__ __forceinline__ void stage_slice(unsigned char* bank_dst, float* q_dst,
                                            const void* bank_v, const float* q, int r0,
                                            int row_end, int d0, int D, int q0, int Q,
                                            int qt, bool vec, bool qvec) {
  const int tid = threadIdx.x;
  if constexpr (kQuant) {
    const int8_t* bank = static_cast<const int8_t*>(bank_v);
    int8_t* dst = reinterpret_cast<int8_t*>(bank_dst);
    const int gr = r0 + tid;
    if (vec) {
      const bool ok = gr < row_end;
      cp_async16(dst + tid * kSlice, ok ? bank + (size_t)gr * D + d0 : bank, ok);
    } else {
      for (int dd = 0; dd < kSlice; ++dd)
        dst[tid * kSlice + dd] =
            (gr < row_end && d0 + dd < D) ? bank[(size_t)gr * D + d0 + dd] : int8_t(0);
    }
  } else {
    const float* bank = static_cast<const float*>(bank_v);
    float* dst = reinterpret_cast<float*>(bank_dst);
    if (vec) {
      for (int e = tid; e < kTileRows * (kSlice / 4); e += kThreads) {
        const int ri = e >> 2, c = e & 3;
        const int gr = r0 + ri, gd = d0 + 4 * c;
        const bool ok = gr < row_end && gd < D;
        cp_async16(dst + ri * kSliceStride + 4 * c, ok ? bank + (size_t)gr * D + gd : bank, ok);
      }
    } else {
      for (int e = tid; e < kTileRows * kSlice; e += kThreads) {
        const int ri = e / kSlice, dd = e % kSlice;
        const int gr = r0 + ri, gd = d0 + dd;
        dst[ri * kSliceStride + dd] = (gr < row_end && gd < D) ? bank[(size_t)gr * D + gd] : 0.f;
      }
    }
  }
  if (q_dst == nullptr) return;
  if (qvec) {
    for (int e = tid; e < qt * (kSlice / 4); e += kThreads) {
      const int qi = e >> 2, c = e & 3;
      const int gq = q0 + qi, gd = d0 + 4 * c;
      const bool ok = gq < Q && gd < D;
      cp_async16(q_dst + qi * kSliceStride + 4 * c, ok ? q + (size_t)gq * D + gd : q, ok);
    }
  } else {
    for (int e = tid; e < qt * kSlice; e += kThreads) {
      const int qi = e / kSlice, dd = e % kSlice;
      const int gq = q0 + qi, gd = d0 + dd;
      q_dst[qi * kSliceStride + dd] = (gq < Q && gd < D) ? q[(size_t)gq * D + gd] : 0.f;
    }
  }
}

template <bool kMasked, bool kQuant, int kQW>
__global__ void __launch_bounds__(kThreads, 1)
topk_scan_kernel(const float* __restrict__ q, const void* __restrict__ bank_v,
                 const float* __restrict__ scales, const int* __restrict__ q_ns,
                 const int* __restrict__ bank_ns, int Q, int D, int n_valid, int k,
                 int n_chunks, bool resident, bool vec, bool qvec,
                 float* __restrict__ part_s, int* __restrict__ part_r,
                 unsigned* floor_key, bool sample) {
  constexpr int kQT = kQW * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pd = padded_depth(D);
  const int bank_stage = kQuant ? kTileRows * kSlice
                                : (int)sizeof(float) * kTileRows * kSliceStride;
  const int stage_bytes = bank_stage + (resident ? 0 : (int)sizeof(float) * kQT * kSliceStride);
  float* conv = reinterpret_cast<float*>(smem + kStages * stage_bytes);  // int8 only
  float* qres = conv + (kQuant ? kTileRows * kSliceStride : 0);          // [kQT][pd]
  float* ls = qres + (resident ? kQT * pd : 0);                          // [kQT][k]
  int* lr = reinterpret_cast<int*>(ls + kQT * k);
  float* bs = reinterpret_cast<float*>(lr + kQT * k);                    // [kQT][kBuf]
  int* br = reinterpret_cast<int*>(bs + kQT * kBuf);
  float* ws_all = reinterpret_cast<float*>(br + kQT * kBuf);             // [kWarps][256]
  int* wr_all = reinterpret_cast<int*>(ws_all + kWarps * kTileRows);
  int* flush_at = wr_all + kWarps * kTileRows;   // [2]: tile of the next joint flush

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* ws = ws_all + warp * kTileRows;   // this warp's tile scratch
  int* wr = wr_all + warp * kTileRows;
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * kQT;
  const int n_tiles = (n_valid + kTileRows - 1) / kTileRows;
  const int t_end = (int)((long long)(chunk + 1) * n_tiles / n_chunks);
  // a sample pass scans the last tile of each chunk
  const int t_begin = sample ? t_end - 1 : (int)((long long)chunk * n_tiles / n_chunks);
  const int row_end = min(n_valid, t_end * kTileRows);
  const int n_slices = max(1, (D + kSlice - 1) / kSlice);
  const int n_steps = (t_end - t_begin) * n_slices;

  for (int i = tid; i < kQT * k; i += kThreads) {
    ls[i] = -CUDART_INF_F;
    lr[i] = kPadRow;
  }
  if (tid < 2) flush_at[tid] = -1;
  if (resident) {
    for (int e = tid; e < kQT * pd; e += kThreads) {
      const int qi = e / pd, dd = e % pd;
      qres[e] = (q0 + qi < Q && dd < D) ? q[(size_t)(q0 + qi) * D + dd] : 0.f;
    }
  }
  int qns[kQW];
  float thr[kQW];
  int cnt[kQW];
#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    const int gq = q0 + warp * kQW + i;
    qns[i] = (kMasked && gq < Q) ? q_ns[gq] : 0;
    thr[i] = -CUDART_INF_F;
    cnt[i] = 0;
  }
  float acc[kQW][kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kQW; ++i)
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.f;

  auto issue = [&](int t) {
    unsigned char* st = smem + (t % kStages) * stage_bytes;
    stage_slice<kQuant>(st, resident ? nullptr : reinterpret_cast<float*>(st + bank_stage),
                        bank_v, q, (t_begin + t / n_slices) * kTileRows, row_end,
                        (t % n_slices) * kSlice, D, q0, Q, kQT, vec, qvec);
  };
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_steps) issue(t);
    cp_async_commit();
  }
  __syncthreads();   // lists and resident queries

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait_one();
    __syncthreads();   // stage t landed; stage t-1 is free
    if (t + kStages - 1 < n_steps) issue(t + kStages - 1);
    cp_async_commit();
    unsigned char* st = smem + (t % kStages) * stage_bytes;
    const int slice = t % n_slices;
    const float* B;
    if constexpr (kQuant) {
      // one thread per row: 16 codes -> 16 exact floats
      const int4 v = *reinterpret_cast<const int4*>(st + tid * kSlice);
      const unsigned w[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z, (unsigned)v.w};
      float* out = conv + tid * kSliceStride;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float4 f;
        f.x = static_cast<float>(static_cast<int8_t>(w[c] & 0xff));
        f.y = static_cast<float>(static_cast<int8_t>((w[c] >> 8) & 0xff));
        f.z = static_cast<float>(static_cast<int8_t>((w[c] >> 16) & 0xff));
        f.w = static_cast<float>(static_cast<int8_t>(w[c] >> 24));
        *reinterpret_cast<float4*>(out + 4 * c) = f;
      }
      __syncthreads();
      B = conv;
    } else {
      B = reinterpret_cast<const float*>(st);
    }
    const float* A = resident ? qres + warp * kQW * pd + slice * kSlice
                              : reinterpret_cast<const float*>(st + bank_stage) +
                                    warp * kQW * kSliceStride;
    const int astride = resident ? pd : kSliceStride;
    const float* Bl = B + lane * kSliceStride;
#pragma unroll
    for (int dd = 0; dd < kSlice; dd += 4) {
      float4 b[kRowsPerLane];
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j)
        b[j] = *reinterpret_cast<const float4*>(Bl + j * 32 * kSliceStride + dd);
#pragma unroll
      for (int i = 0; i < kQW; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(A + i * astride + dd);
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
    if (slice != n_slices - 1) continue;

    // the tile's scores are complete: select, warp by warp
    const int tile = t / n_slices;
    const int r0 = (t_begin + tile) * kTileRows;
    // a joint flush posted at the last tile: every warp merges its buffers
    // now, so that the merges of all warps overlap between two barriers
    if (flush_at[tile & 1] == tile) {
#pragma unroll
      for (int i = 0; i < kQW; ++i) {
        const int qi = warp * kQW + i;
        if (q0 + qi < Q && cnt[i] > 0) {
          sort_merge<kBuf / 32>(ls + qi * k, lr + qi * k, k, bs + qi * kBuf, br + qi * kBuf,
                                cnt[i], cnt[i]);
          cnt[i] = 0;
          raise_floor(floor_key + q0 + qi, ls + qi * k, lr + qi * k, k, thr[i]);
          thr[i] = ls[qi * k + k - 1];
        }
      }
    }
    bool post = false;
    float scl[kRowsPerLane];
    int lab[kRowsPerLane];
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const int row = r0 + lane + 32 * j;
      scl[j] = (kQuant && row < row_end) ? scales[row] : 0.f;
      lab[j] = (kMasked && row < row_end) ? bank_ns[row] : 0;
    }
    // every chunk's full list raises its query's floor: the k-th score of
    // k live rows, so no row scoring below it can enter the final top-k
    float fl[kQW];
#pragma unroll
    for (int i = 0; i < kQW; ++i) {
      const int gq = q0 + warp * kQW + i;
      fl[i] = gq < Q ? key_score(*reinterpret_cast<volatile unsigned*>(floor_key + gq))
                     : -CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < kQW; ++i) {
      const int qi = warp * kQW + i;
      if (q0 + qi < Q) {   // warp-uniform
        float* qls = ls + qi * k;
        int* qlr = lr + qi * k;
        float* qbs = bs + qi * kBuf;
        int* qbr = br + qi * kBuf;
        float sv[kRowsPerLane];
        int c = 0;
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          sv[j] = acc[i][j];
          if constexpr (kQuant) sv[j] = sv[j] * scl[j];   // after the sum, as the reference
          bool ok = r0 + lane + 32 * j < row_end && sv[j] > thr[i] && sv[j] >= fl[i];
          if constexpr (kMasked) ok = ok && lab[j] == qns[i];
          if (!ok) sv[j] = -CUDART_INF_F;
          c += __popc(__ballot_sync(kFull, ok));
        }
        if (c > 0) {   // warp-uniform
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) ws[32 * j + lane] = sv[j];
          cnt[i] = admit(qls, qlr, k, qbs, qbr, cnt[i], ws, wr, c, r0);
          raise_floor(floor_key + q0 + qi, qls, qlr, k, thr[i]);
          thr[i] = qls[k - 1];
          post = post || cnt[i] > kBuf / 2;
        }
      }
    }
    // a buffer past half full could overflow at the next tile (which adds
    // fewer than kBuf / 2): post a joint flush there.  Slot parity keeps
    // this tile's reads and the next tile's posts apart (barriers between).
    if (post && lane == 0) flush_at[(tile + 1) & 1] = tile + 1;
#pragma unroll
    for (int i = 0; i < kQW; ++i)
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    const int qi = warp * kQW + i;
    if (q0 + qi >= Q) continue;   // warp-uniform
    if (cnt[i] > 0)
      sort_merge<kBuf / 32>(ls + qi * k, lr + qi * k, k, bs + qi * kBuf, br + qi * kBuf, cnt[i],
                            cnt[i]);
    const size_t base = ((size_t)(q0 + qi) * n_chunks + chunk) * k;
    for (int e = lane; e < k; e += 32) {
      part_s[base + e] = ls[qi * k + e];
      part_r[base + e] = lr[qi * k + e];
    }
  }
}

// Pass 2's dynamic shared memory: one list and one scratch segment a warp.
size_t merge_lists_smem_bytes(int k) {
  return (sizeof(float) + sizeof(int)) * (size_t)kWarps * (k + kSeg);
}

__global__ void __launch_bounds__(kThreads)
topk_merge_lists_kernel(const float* __restrict__ part_s, const int* __restrict__ part_r,
                        int k, int n_chunks, float* __restrict__ out_s,
                        int* __restrict__ out_i, unsigned* __restrict__ floor_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ls = reinterpret_cast<float*>(smem);              // [kWarps][k]
  int* lr = reinterpret_cast<int*>(ls + kWarps * k);
  float* ss = reinterpret_cast<float*>(lr + kWarps * k);   // [kWarps][kSeg]
  int* sr = reinterpret_cast<int*>(ss + kWarps * kSeg);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int qq = blockIdx.x;
  for (int i = tid; i < kWarps * k; i += kThreads) {
    ls[i] = -CUDART_INF_F;
    lr[i] = kPadRow;
  }
  __syncthreads();
  float* wls = ls + warp * k;
  int* wlr = lr + warp * k;
  float* wss = ss + warp * kSeg;
  int* wsr = sr + warp * kSeg;
  for (int c = warp; c < n_chunks; c += kWarps) {
    const float* cs = part_s + ((size_t)qq * n_chunks + c) * k;
    const int* cr = part_r + ((size_t)qq * n_chunks + c) * k;
    for (int s0 = 0; s0 < k; s0 += kSeg)
      if (!admit_segment(wls, wlr, k, cs + s0, cr + s0, min(kSeg, k - s0), wss, wsr)) break;
  }
  __syncthreads();
  for (int step = 1; step < kWarps; step <<= 1) {
    if (warp % (2 * step) == 0) {
      const float* os = ls + (warp + step) * k;
      const int* orr = lr + (warp + step) * k;
      for (int s0 = 0; s0 < k; s0 += kSeg)
        if (!admit_segment(wls, wlr, k, os + s0, orr + s0, min(kSeg, k - s0), wss, wsr)) break;
    }
    __syncthreads();
  }
  if (floor_out != nullptr) {   // a sample pass: only the k-th score
    if (tid == 0) floor_out[qq] = lr[k - 1] != kPadRow ? score_key(ls[k - 1]) : 0u;
    return;
  }
  for (int i = tid; i < k; i += kThreads) {
    const bool live = lr[i] != kPadRow;
    out_s[(size_t)qq * k + i] = live ? ls[i] : kNegInf;
    out_i[(size_t)qq * k + i] = live ? lr[i] : -1;
  }
}

template <bool kMasked, bool kQuant>
const void* scan_instance(int qw) {
  switch (qw) {
    case 8: return reinterpret_cast<const void*>(topk_scan_kernel<kMasked, kQuant, 8>);
    case 4: return reinterpret_cast<const void*>(topk_scan_kernel<kMasked, kQuant, 4>);
    case 2: return reinterpret_cast<const void*>(topk_scan_kernel<kMasked, kQuant, 2>);
    case 1: return reinterpret_cast<const void*>(topk_scan_kernel<kMasked, kQuant, 1>);
    default: return nullptr;
  }
}

const void* scan_kernel(bool masked, bool quant, int qw) {
  if (masked) return quant ? scan_instance<true, true>(qw) : scan_instance<true, false>(qw);
  return quant ? scan_instance<false, true>(qw) : scan_instance<false, false>(qw);
}

// Raise every scan instance's and the list merge's shared-memory ceiling
// to kSmemMax, once per device.
cudaError_t raise_scan_ceilings() {
  static int done_device = -1;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device == done_device) return err;
  for (int m = 0; m < 2; ++m)
    for (int qn = 0; qn < 2; ++qn)
      for (int qw : kScanWidths)
        if ((err = cudaFuncSetAttribute(scan_kernel(m, qn, qw),
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        kSmemMax)) != cudaSuccess)
          return err;
  if ((err = cudaFuncSetAttribute(reinterpret_cast<const void*>(topk_merge_lists_kernel),
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax)) !=
      cudaSuccess)
    return err;
  done_device = device;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Pass 1's dynamic shared memory of the partial kernel for list length k.
size_t topk_mips_partial_smem_bytes(int k) { return partial_smem_bytes(k); }

// The scan kernel's dynamic shared memory for a query tile of
// `queries_per_tile` queries (bytes).
size_t topk_mips_scan_smem_bytes(int k, int quant, int D, int queries_per_tile,
                                 int resident) {
  return scan_smem_bytes(k, quant != 0, D, queries_per_tile, resident != 0);
}

// The scan kernel's query tile for (k, quant, D): 2 * queries + resident,
// or 0 if no tile fits.
int topk_mips_scan_tile(int k, int quant, int D) {
  bool resident = false;
  const int qw = scan_width(k, quant != 0, D, &resident);
  return qw == 0 ? 0 : 2 * 8 * qw + (resident ? 1 : 0);
}

// Resident pass-1 CTAs per SM of the kernel a call with these arguments
// launches (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *ctas.
// Returns the CUDA error code.
int topk_mips_occupancy(int masked, int quant, int k, int D, int* ctas) {
  cudaError_t err;
  if (masked && k <= kMaxK) {
    if ((err = raise_smem_ceiling<true, false>()) != cudaSuccess) return (int)err;
    if ((err = raise_smem_ceiling<true, true>()) != cudaSuccess) return (int)err;
    const void* fn = quant ? reinterpret_cast<const void*>(topk_partial_kernel<true, true>)
                           : reinterpret_cast<const void*>(topk_partial_kernel<true, false>);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreads,
                                                              partial_smem_bytes(k));
  }
  bool resident = false;
  const int qw = scan_width(k, quant != 0, D, &resident);
  if (qw == 0) return (int)cudaErrorInvalidValue;
  if ((err = raise_scan_ceilings()) != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, scan_kernel(masked != 0, quant != 0, qw), kThreads,
      scan_smem_bytes(k, quant != 0, D, 8 * qw, resident));
}

// Launch both passes on `stream`.  `bank` is f32 (quant == 0) or int8 codes
// with per-row `scales` (quant != 0); `q_ns`/`bank_ns` are read only when
// masked != 0.  part_s holds Q * n_chunks * k entries, part_r Q more (the
// scan kernel's per-query score floors).  Masked calls
// with k <= 256 (K1, K2 on the service's path) run the partial kernel and
// its warp-per-query merge: rows_per_chunk is then a multiple of its 64-row
// tile.  Every other call runs the scan kernel and the list merge, which
// split the live prefix's 256-row tiles evenly over n_chunks (at most one
// chunk a tile) and ignore rows_per_chunk.  Returns the CUDA error code of
// the launches (0 on success).
int topk_mips_launch(const float* q, const void* bank, const float* scales,
                     const int* q_ns, const int* bank_ns, int Q, int D,
                     int n_valid, int k, int masked, int quant, int n_chunks,
                     int rows_per_chunk, float* part_s, int* part_r,
                     float* out_s, int* out_i, void* stream) {
  const bool partial = masked && k <= kMaxK;
  const int n_tiles = (n_valid + kTileRows - 1) / kTileRows;
  if (Q < 0 || D < 0 || n_valid < 0 || k < 1 || k > kScanMaxK || n_chunks < 0 ||
      (partial && n_chunks > 0 && (rows_per_chunk <= 0 || rows_per_chunk % kBN != 0)) ||
      (!partial && n_chunks > n_tiles) ||
      (n_chunks > 0 && masked && (q_ns == nullptr || bank_ns == nullptr)) ||
      (n_chunks > 0 && quant && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!partial) {
    if ((err = raise_scan_ceilings()) != cudaSuccess) return (int)err;
    if (n_chunks > 0) {
      bool resident = false;
      const int qw = scan_width(k, quant != 0, D, &resident);
      if (qw == 0) return (int)cudaErrorInvalidValue;
      const int qt = 8 * qw;
      const dim3 grid(n_chunks, (Q + qt - 1) / qt);
      const size_t smem = scan_smem_bytes(k, quant != 0, D, qt, resident);
      const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
      const uintptr_t ba = reinterpret_cast<uintptr_t>(bank);
      bool vec = quant ? (D % 16 == 0 && ba % 16 == 0) : (D % 4 == 0 && ba % 16 == 0);
      bool qvec = D % 4 == 0 && qa % 16 == 0;
      unsigned* floor_key = reinterpret_cast<unsigned*>(part_r + (size_t)Q * n_chunks * k);
      if ((err = cudaMemsetAsync(floor_key, 0, sizeof(unsigned) * Q, st)) != cudaSuccess)
        return (int)err;
      const void* scan = scan_kernel(masked != 0, quant != 0, qw);
      // A sample pass when chunks are long: the last tile of each chunk, one
      // a CTA, merged exactly; their k-th score becomes each query's floor.
      bool sample = n_tiles >= kSampleRatio * n_chunks;
      void* args[] = {(void*)&q,       (void*)&bank,   (void*)&scales, (void*)&q_ns,
                      (void*)&bank_ns, (void*)&Q,      (void*)&D,      (void*)&n_valid,
                      (void*)&k,       (void*)&n_chunks, (void*)&resident, (void*)&vec,
                      (void*)&qvec,    (void*)&part_s, (void*)&part_r, (void*)&floor_key,
                      (void*)&sample};
      if (sample) {
        if ((err = cudaLaunchKernel(scan, grid, dim3(kThreads), args, smem, st)) != cudaSuccess)
          return (int)err;
        topk_merge_lists_kernel<<<Q, kThreads, merge_lists_smem_bytes(k), st>>>(
            part_s, part_r, k, n_chunks, out_s, out_i, floor_key);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      }
      sample = false;
      if ((err = cudaLaunchKernel(scan, grid, dim3(kThreads), args, smem, st)) != cudaSuccess)
        return (int)err;
    }
    topk_merge_lists_kernel<<<Q, kThreads, merge_lists_smem_bytes(k), st>>>(
        part_s, part_r, k, n_chunks, out_s, out_i, nullptr);
    return (int)cudaGetLastError();
  }
  // Pass 1 takes more dynamic shared memory than the default 48 KB ceiling
  // (pass 2 stays below it).  Raise the ceiling of every variant on the
  // first launch on a device, to what k = kMaxK needs, which covers every k.
  static int smem_device = -1;
  int device;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != smem_device) {
    if ((err = raise_smem_ceiling<true, false>()) != cudaSuccess) return (int)err;
    if ((err = raise_smem_ceiling<true, true>()) != cudaSuccess) return (int)err;
    smem_device = device;
  }
  if (n_chunks > 0) {
    const dim3 grid(n_chunks, (Q + kQT - 1) / kQT);
    const size_t smem = partial_smem_bytes(k);
    const bool vec16 = quant && D % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(bank) % 16 == 0;
    if (quant)
      launch_partial<true, true>(grid, smem, st, q, bank, scales, q_ns, bank_ns, Q, D,
                                 n_valid, k, rows_per_chunk, n_chunks, vec16, part_s, part_r);
    else
      launch_partial<true, false>(grid, smem, st, q, bank, scales, q_ns, bank_ns, Q, D,
                                  n_valid, k, rows_per_chunk, n_chunks, vec16, part_s, part_r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  topk_merge_kernel<<<(Q + kWarps - 1) / kWarps, kThreads, merge_smem_bytes(k), st>>>(
      part_s, part_r, Q, k, n_chunks, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
