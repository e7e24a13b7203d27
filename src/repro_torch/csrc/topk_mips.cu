// Exact top-k maximum-inner-product search for Hopper: the four Pallas TPU
// kernels of src/repro/kernels/topk_mips.py as one CUDA design, the scan
// kernel, a template over <kMasked, kQuant>, behind one C entry point.
//
//   K1 <true,  false>  `_kernel_masked` + `_merge_topk`  (pallas_call :227)
//   K2 <true,  true>   `_kernel_quant_masked`            (pallas_call :227)
//   K3 <false, false>  `_kernel`                         (pallas_call :210)
//   K4 <false, true>   `_kernel_quant`                   (pallas_call :210)
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
// What bounds it.  Unmasked: the plain-FP32 product, 2*Q*N*D flops.  Q=64,
// N=2^20, D=256: 34.4 GFLOP -> 0.51 ms at 67 TFLOP/s of non-tensor-core
// FP32, against a bank read of 1.07 GB -> 0.32 ms at 3.35 TB/s for f32 and
// 0.28 GB -> 0.08 ms for int8 codes: the int8 bank moves a quarter of the
// bytes but does the same operations, so K4 is bounded by the operations
// too.  TF32 (or int8) tensor cores would be faster but keep ~3 decimal
// digits of the query, which breaks the rtol=1e-5 parity the reference
// holds, so the product stays in FP32 FMA.  Every score is a single fmaf
// chain over d = 0..D-1 in order (then one multiply by the row's scale),
// whatever tile or CTA its row lands in, so identical rows score
// bit-identically and the tie rule is exact.
//
// Masked (K1, K2): the mask keeps few of the pairs.  A namespace owns a few
// rows to a few thousand of the bank, so a tile of 64 queries matches ~0.2%
// to ~8% of the rows and each query far fewer.  The least work is to read
// both label vectors, each matching row once and one dot product per
// matching (query, row) pair: ~0.03 ms at the main shape, not 0.51.  The
// Pallas kernel scores every pair and masks afterwards, which the TPU's
// matrix unit makes cheap; here FP32 FMA is the scarce resource, so a
// masked call first compacts the bank by label (topk_count_kernel +
// topk_compact_kernel): per query tile, the live rows whose label equals
// any of the tile's query labels, in ascending row order, written to a
// device list without a read back to the host.  The scan kernel then
// stages and scores only the listed rows.  What bounds a masked call now
// is the product of the listed rows against the whole query tile (a row
// matches one or a few of the tile's queries, so most of those products
// are still masked out), the tiles' per-tile latency when few tiles are
// listed, and the launches.  With one label on every row and query (the
// single-tenant search) every row is listed, and K1/K2 do K3's/K4's work
// plus one pass over the labels.
//
// Launches of one call: [count, compact] (masked), [sample scan, sample
// merge] (long chunks), scan, merge.  Past k = kScanMaxK a call runs the
// large-k path instead (its section below): per chunk of queries, [a plan
// grouping the queries by label, the compaction of each grouped tile], a
// score pass into a device workspace, an exact radix select that filters
// as it goes, and a sort in shared-memory runs and merge rounds whose last
// stage writes the outputs.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPadRow = 0x7fffffff;
constexpr float kNegInf = -2.0e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool ranks_before(float sa, int ra, float sb, int rb) {
  return sa > sb || (sa == sb && ra < rb);
}

// ---------------------------------------------------------------------------
// Label compaction (masked calls), ahead of the scan kernel.  One CTA per
// (row block, query tile); the query tile is the scan kernel's.  Each CTA
// sorts its tile's labels in shared memory and tests a row's label with a
// binary search.  topk_count_kernel counts each block's matching rows;
// topk_compact_kernel sums the counts of the blocks before its own and
// writes its matching rows there, in ascending order, so that the tile's
// list is the bank's matching rows in row order; its last block writes
// the list's length.  The scan kernel reads that length on the device.
// Both read the labels in batches of 4 consecutive rows a thread (1,024
// rows a block), all loads issued before the first test; the write pass
// stages a batch's matches in shared memory and stores them coalesced.
// ---------------------------------------------------------------------------

constexpr int kMaxTileQueries = 64;   // the widest query tile of the scan kernel
constexpr int kCompactRun = 4;        // consecutive rows a thread tests in a batch
constexpr int kCompactBatch = kThreads * kCompactRun;
constexpr int kCompactMaxBlocks = 1024;

__host__ __device__ inline int compact_rows_per_block(int n_valid) {
  const int batches = (n_valid + kCompactBatch - 1) / kCompactBatch;
  const int per = (batches + kCompactMaxBlocks - 1) / kCompactMaxBlocks;
  return (per > 1 ? per : 1) * kCompactBatch;
}

__host__ __device__ inline int compact_blocks(int n_valid) {
  const int rows = compact_rows_per_block(n_valid);
  return (n_valid + rows - 1) / rows;
}

// lab[0, n) = src[0, n) sorted ascending (n <= kThreads).  Block-collective.
__device__ __forceinline__ void sort_labels(const int* src, int n, int* raw, int* lab) {
  const int tid = threadIdx.x;
  if (tid < n) raw[tid] = src[tid];
  __syncthreads();
  if (tid < n) {
    const int v = raw[tid];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += (raw[j] < v || (raw[j] == v && j < tid)) ? 1 : 0;
    lab[rank] = v;
  }
  __syncthreads();
}

// The labels of query tile blockIdx.y (qt queries from q0) into lab[0, n),
// sorted ascending; returns n.  Block-collective.
__device__ int tile_labels(const int* q_ns, int Q, int qt, int* raw, int* lab) {
  const int q0 = blockIdx.y * qt;
  const int n = min(qt, Q - q0);
  sort_labels(q_ns + q0, n, raw, lab);
  return n;
}

// Whether x is among the sorted lab[0, n) (n >= 1).
__device__ __forceinline__ bool label_in(const int* lab, int n, int x) {
  int pos = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
    if (lab[pos + half] <= x) pos += half;
    len -= half;
  }
  return lab[pos] == x;
}

// Bit i set where row r0 + i (< r_end) carries one of the sorted labels.
__device__ __forceinline__ unsigned match_run(const int* __restrict__ bank_ns, int r0,
                                              int r_end, const int* lab, int n) {
  int v[kCompactRun];
#pragma unroll
  for (int i = 0; i < kCompactRun; ++i) v[i] = r0 + i < r_end ? bank_ns[r0 + i] : 0;
  unsigned bits = 0u;
#pragma unroll
  for (int i = 0; i < kCompactRun; ++i)
    if (r0 + i < r_end && label_in(lab, n, v[i])) bits |= 1u << i;
  return bits;
}

// The count pass of one (row block, query tile `tile`) against the tile's
// sorted labels lab[0, n): the block's matching rows into counts.
// Block-collective.
__device__ __forceinline__ void count_rows(const int* __restrict__ bank_ns, int n_valid,
                                           const int* lab, int n, int tile, int* warp_sum,
                                           int* __restrict__ counts) {
  const int tid = threadIdx.x;
  const int per = compact_rows_per_block(n_valid);
  const int r_begin = blockIdx.x * per;
  const int r_end = (int)min((long long)n_valid, (long long)r_begin + per);
  int c = 0;
  for (int base = r_begin; base < r_end; base += kCompactBatch)
    c += __popc(match_run(bank_ns, base + tid * kCompactRun, r_end, lab, n));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = c;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
    counts[tile * gridDim.x + blockIdx.x] = total;
  }
}

// The write pass of one (row block, query tile): the block's matching rows
// at its place in the tile's list (after the matches of the blocks before
// it), in ascending order; the last block writes the list's length.
// Block-collective.
__device__ __forceinline__ void compact_rows(const int* __restrict__ bank_ns, int n_valid,
                                             const int* lab, int n, int tile,
                                             const int* __restrict__ counts,
                                             int* __restrict__ list, int list_stride,
                                             int* __restrict__ list_len, int* warp_sum,
                                             int* staged) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this block's place in the list: the matches of the blocks before it
  int before = 0;
  for (int b = tid; b < (int)blockIdx.x; b += kThreads) before += counts[tile * gridDim.x + b];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(kFull, before, o);
  if (lane == 0) warp_sum[warp] = before;
  __syncthreads();
  int off = 0;
  for (int w = 0; w < kWarps; ++w) off += warp_sum[w];
  __syncthreads();
  int* out = list + (size_t)tile * list_stride;
  const int per = compact_rows_per_block(n_valid);
  const int r_begin = blockIdx.x * per;
  const int r_end = (int)min((long long)n_valid, (long long)r_begin + per);
  for (int base = r_begin; base < r_end; base += kCompactBatch) {
    // thread t tests rows r0 .. r0 + 3; its matches go after those of the
    // threads before it (a block-wide exclusive scan of the counts)
    const int r0 = base + tid * kCompactRun;
    unsigned bits = match_run(bank_ns, r0, r_end, lab, n);
    const int c = __popc(bits);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int at = incl - c, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? warp_sum[w] : 0;
      total += warp_sum[w];
    }
    for (; bits != 0u; bits &= bits - 1u) staged[at++] = r0 + __ffs(bits) - 1;
    __syncthreads();
    for (int i = tid; i < total; i += kThreads) out[off + i] = staged[i];
    off += total;
    __syncthreads();   // warp_sum and staged are rewritten next batch
  }
  if (blockIdx.x == gridDim.x - 1 && tid == 0) list_len[tile] = off;
}

__global__ void __launch_bounds__(kThreads)
topk_count_kernel(const int* __restrict__ q_ns, const int* __restrict__ bank_ns, int Q,
                  int n_valid, int qt, int* __restrict__ counts) {
  __shared__ int raw[kMaxTileQueries], lab[kMaxTileQueries], warp_sum[kWarps];
  const int n = tile_labels(q_ns, Q, qt, raw, lab);
  count_rows(bank_ns, n_valid, lab, n, blockIdx.y, warp_sum, counts);
}

__global__ void __launch_bounds__(kThreads)
topk_compact_kernel(const int* __restrict__ q_ns, const int* __restrict__ bank_ns, int Q,
                    int n_valid, int qt, const int* __restrict__ counts,
                    int* __restrict__ list, int list_stride, int* __restrict__ list_len) {
  __shared__ int raw[kMaxTileQueries], lab[kMaxTileQueries], warp_sum[kWarps];
  __shared__ int staged[kCompactBatch];   // a batch's matches, in row order
  const int n = tile_labels(q_ns, Q, qt, raw, lab);
  compact_rows(bank_ns, n_valid, lab, n, blockIdx.y, counts, list, list_stride, list_len,
               warp_sum, staged);
}

// ---------------------------------------------------------------------------
// The scan kernel: all four kernels, at every k up to kScanMaxK.
//
// pass 1  topk_scan_kernel<kMasked, kQuant, kQW>: one CTA per (chunk, query
//         tile of 8*kQW queries).  It walks entries: unmasked, entry e is
//         row e of the live prefix; masked, it is the e-th row of the query
//         tile's compacted list, whose length the CTA reads on the device.
//         The entries' 256-row tiles are split evenly over the chunks, so a
//         skewed bank (one namespace owning a long run of rows) is balanced
//         by what each chunk scores; a chunk with no tile writes empty
//         lists.  The launch plan is made from n_valid alone.  Warp w owns
//         queries w*kQW .. w*kQW+kQW-1 of the tile for the whole chunk:
//         their scores, thresholds, candidate buffers and lists, so
//         selection needs no block barrier.  Lane l owns entries l + 32 j
//         (j < 8) of each tile, a kQW x 8 register tile of scores, fed per
//         4 depths by 8 + kQW 16-byte shared loads for 32 kQW FMAs.  The
//         bank streams through a 3-stage ring of 16-deep slices (16-byte
//         cp.async per row piece, zero-filled past the edges), stored
//         [row][d] with a 20-float row stride (conflict-free 16-byte
//         reads); masked, each tile's 256 row ids are read once into
//         shared memory (one of three buffers, so that the selection of a
//         tile still finds them while later tiles are staged) and the
//         copies gather through them.  int8 codes land raw and are
//         converted to f32 once per element, smem -> smem, before the
//         product.  The query tile stays in shared memory for the whole CTA
//         when it fits (`resident`, copied with the ring's first stage),
//         otherwise its 16-deep slice rides in each ring stage.  The query
//         tile is the widest (64, 32, 16, 8) whose lists, buffers and ring
//         fit in a block's 227 KB: 64 at the main shapes (f32 k = 64, int8
//         k = 256), 32 for f32 at k = 256, 8 at k = 2048.
// pass 2  topk_merge_lists_kernel: one CTA per query; warp w merges chunk
//         lists w, w+8, ... into its own list, then the 8 lists merge in a
//         tree of three rounds.  Pass 1 writes a list's live entries and
//         one empty entry after them (a CTA with no tile writes just that
//         and exits), and the merge stops at a list's first entry that does
//         not rank before its own k-th, so an empty or short chunk list
//         costs one 32-entry read.
//
// Selection (pass 1).  A tile's score s of row r for query i is a candidate
// iff its entry is live, the labels match (masked: a listed row matches
// some query of the tile, not necessarily this one), s > thr[i] (the k-th
// score of the query's merged list, -inf until it is full) and s >= the
// query's floor (below).  Few candidates in a tile (< kBuf / 2) are
// appended to the query's buffer (ballot + popc); many -- a chunk's first
// tiles -- are sorted as a whole tile in registers and merged into the
// list at once.  A buffer past half full posts a joint flush: at the next
// tile every warp sorts and merges all its buffers, so the merges of all
// warps overlap between two barriers instead of each stalling the CTA in
// turn.  The selection each tile runs is short code; the rest (`admit`,
// `sort_merge`, `merge_sorted`) is out of line, so the tile loop stays in
// the instruction cache.
//
// Dropping a score that merely EQUALS thr[i] is exact: tiles run through a
// chunk in ascending entry order, and entries ascend with the row (the
// compacted list keeps row order), so every entry of the merged list has a
// lower row than the candidate, which ranks after the k-th entry.  The
// merge pass has no such order (warps take interleaved chunks), so it
// admits by the full key (score desc, row asc).
//
// Floors.  floor_key[q] holds a score that k live rows reach, so a row
// scoring below it cannot enter the final top-k (one that equals it may,
// by row, and is kept).  Every chunk whose list is full raises it to its
// k-th score (atomicMax on an order-preserving key).  When chunks hold at
// least kSampleRatio tiles (for a masked call, tiles of its list: each CTA
// decides on the device), a sample pass first scans the last tile of each
// chunk (one a CTA) and merges them exactly: their k-th score is the floor
// the main pass starts from, so in a bank of random order only
// ~k * rows / (256 n_chunks) rows of each chunk pass it, and in a bank
// whose scores rise with the row almost none but the last chunk's.
// ---------------------------------------------------------------------------

constexpr int kScanMaxK = 2048;
constexpr int kTileRows = 256;      // entries per tile: lane l owns l + 32 j
constexpr int kRowsPerLane = kTileRows / 32;
constexpr int kSlice = 16;          // depth of one ring stage
constexpr int kSliceStride = kSlice + 4;   // floats per staged row
constexpr int kStages = 3;
constexpr int kIdBufs = 3;          // masked: row-id buffers of the tiles in flight
constexpr int kBuf = 64;            // candidate buffer of one query (pow2)
constexpr int kSeg = 256;           // merge pass: list entries per admission
constexpr int kSmemMax = 232448;    // dynamic shared memory a block can use
constexpr int kScanWidths[4] = {8, 4, 2, 1};   // kQW, widest first
constexpr int kSampleRatio = 4;     // sample pass when chunks hold >= 4 tiles

static_assert(kTileRows == kThreads, "int8 staging and the row ids give each thread a row");
static_assert(kBuf % 32 == 0 && (kBuf & (kBuf - 1)) == 0, "kBuf is a pow2 of warps");
static_assert(kSeg % 32 == 0, "kSeg is whole warps");
static_assert(8 * kScanWidths[0] <= kMaxTileQueries, "compaction holds a tile's labels");

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
// candidate buffers and a tile's worth of scratch a warp (8 bytes an entry),
// and for a masked call the row ids of the tiles in flight.
size_t scan_smem_bytes(int k, bool quant, int D, int qt, bool resident, bool masked) {
  const size_t bank_stage = quant ? (size_t)kTileRows * kSlice
                                  : sizeof(float) * kTileRows * kSliceStride;
  const size_t q_stage = resident ? 0 : sizeof(float) * qt * kSliceStride;
  const size_t conv = quant ? sizeof(float) * kTileRows * kSliceStride : 0;
  const size_t qres = resident ? sizeof(float) * qt * padded_depth(D) : 0;
  const size_t ids = masked ? sizeof(int) * kIdBufs * kTileRows : 0;
  return kStages * (bank_stage + q_stage) + conv + qres +
         (sizeof(float) + sizeof(int)) * ((size_t)qt * (k + kBuf) + kWarps * kTileRows) +
         2 * sizeof(int) + ids;
}

// The widest warp query width kQW whose tile fits, and whether its queries
// can stay resident.  0 if none fits (never for k <= kScanMaxK).
int scan_width(int k, bool quant, int D, bool masked, bool* resident) {
  for (int qw : kScanWidths) {
    if (scan_smem_bytes(k, quant, D, 8 * qw, false, masked) <= (size_t)kSmemMax) {
      *resident = scan_smem_bytes(k, quant, D, 8 * qw, true, masked) <= (size_t)kSmemMax;
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
// score of the tile's entry 32 j + lane where it passed the query's
// threshold and mask, -inf elsewhere; that entry's row is ids[e] (masked)
// or e0 + e.  Many (c >= kBuf / 2): sort the whole tile and merge it into
// the list at once.  Few: append them to the query's buffer (cnt entries),
// merging the buffer first should it overflow.  Returns the buffer's new
// count.  Kept out of line, so the selection each tile runs is short code.
// Warp-collective.
__device__ __noinline__ int admit(float* ls, int* lr, int k, float* bs, int* br, int cnt,
                                  float* ws, int* wr, int c, int e0, const int* ids) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (c >= kBuf / 2) {
    for (int e = lane; e < kTileRows; e += 32)
      wr[e] = ws[e] > -CUDART_INF_F ? (ids ? ids[e] : e0 + e) : kPadRow;
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
      br[p] = ids ? ids[e] : e0 + e;
    }
    cnt += __popc(m);
  }
  __syncwarp();
  return cnt;
}

// Merge pass: admit the entries of one sorted segment (len <= kSeg) that
// rank before the list's k-th entry -- a prefix, as the segment is sorted;
// the first entry that does not ends it, and what follows it is not read
// as an entry (pass 1 leaves it unwritten past a list's live entries) --
// through scratch into the list.  Returns whether the whole segment was
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
    const unsigned m = __ballot_sync(kFull, in && ranks_before(s, r, ts, tr));
    const int c = m == kFull ? 32 : __ffs(~m) - 1;   // the admitted prefix
    if (lane < c) {
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

// Issue the copies of one ring stage: the 256 x 16 bank slice at depth d0
// of the tile whose first entry is e0 and, unless the queries are
// resident, the query tile's slice.  Entry e0 + i is live below e_end and
// is row ids[i] (masked) or e0 + i.  `vec`: the bank's rows can be read in
// aligned 16-byte pieces (f32: D % 4 == 0; int8: D % 16 == 0); `qvec` the
// same for the queries.  Otherwise plain loads.
template <bool kQuant>
__device__ __forceinline__ void stage_slice(unsigned char* bank_dst, float* q_dst,
                                            const void* bank_v, const float* q, int e0,
                                            int e_end, const int* ids, int d0, int D, int q0,
                                            int Q, int qt, bool vec, bool qvec) {
  const int tid = threadIdx.x;
  if constexpr (kQuant) {
    const int8_t* bank = static_cast<const int8_t*>(bank_v);
    int8_t* dst = reinterpret_cast<int8_t*>(bank_dst);
    const bool live = e0 + tid < e_end;
    const size_t gr = ids ? ids[tid] : e0 + tid;
    if (vec) {
      cp_async16(dst + tid * kSlice, live ? bank + gr * D + d0 : bank, live);
    } else {
      for (int dd = 0; dd < kSlice; ++dd)
        dst[tid * kSlice + dd] = (live && d0 + dd < D) ? bank[gr * D + d0 + dd] : int8_t(0);
    }
  } else {
    const float* bank = static_cast<const float*>(bank_v);
    float* dst = reinterpret_cast<float*>(bank_dst);
    if (vec) {
      for (int e = tid; e < kTileRows * (kSlice / 4); e += kThreads) {
        const int ri = e >> 2, c = e & 3;
        const int gd = d0 + 4 * c;
        const bool ok = e0 + ri < e_end && gd < D;
        const size_t gr = ids ? ids[ri] : e0 + ri;
        cp_async16(dst + ri * kSliceStride + 4 * c, ok ? bank + gr * D + gd : bank, ok);
      }
    } else {
      for (int e = tid; e < kTileRows * kSlice; e += kThreads) {
        const int ri = e / kSlice, dd = e % kSlice;
        const int gd = d0 + dd;
        const size_t gr = ids ? ids[ri] : e0 + ri;
        dst[ri * kSliceStride + dd] = (e0 + ri < e_end && gd < D) ? bank[gr * D + gd] : 0.f;
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

// A query tile's kQT queries into qres ([kQT][padded_depth(D)], zero
// padded), by cp.async when `qvec` (committed with the ring's first stage
// and waited for at its step 0), else by plain loads.
template <int kQT>
__device__ __forceinline__ void load_queries(float* qres, const float* q, int Q, int D, int q0,
                                             bool qvec) {
  const int pd = padded_depth(D);
  const int tid = threadIdx.x;
  if (qvec) {
    for (int e = tid; e < kQT * (pd / 4); e += kThreads) {
      const int qi = e / (pd / 4), d = 4 * (e % (pd / 4));
      const bool ok = q0 + qi < Q && d < D;
      cp_async16(qres + qi * pd + d, ok ? q + (size_t)(q0 + qi) * D + d : q, ok);
    }
  } else {
    for (int e = tid; e < kQT * pd; e += kThreads) {
      const int qi = e / pd, dd = e % pd;
      qres[e] = (q0 + qi < Q && dd < D) ? q[(size_t)(q0 + qi) * D + dd] : 0.f;
    }
  }
}

// A CTA's ring over entry steps [0, n_steps) of its chunk (n_slices steps
// a tile, the tiles from t_begin on): the copies of each step's bank slice
// (and query slice unless the queries are `resident` in qres, put there by
// load_queries before the call), kStages deep; int8 codes converted to
// exact floats in `conv`; and the fmaf chain of each warp's kQW queries
// against its lanes' kRowsPerLane rows.  When a tile's last slice is in,
// calls tile_done(tile, e0, ids, acc) -- e0 its first entry, ids its row
// ids (masked, else null), acc the scores -- then zeroes acc.  Shared by
// the scan kernel and the large-k score pass, so both give the same score
// bits.  Block-collective; the caller's shared state is visible after the
// barrier behind the ring's first stages.
template <bool kMasked, bool kQuant, int kQW, typename TileDone>
__device__ __forceinline__ void scan_tiles(unsigned char* smem, int stage_bytes, int bank_stage,
                                           float* conv, float* qres, int* ids_all,
                                           const float* q, const void* bank_v, const int* rows,
                                           int Q, int D, int q0, int t_begin, int e_end,
                                           int n_steps, int n_slices, bool resident, bool vec,
                                           bool qvec, TileDone&& tile_done) {
  constexpr int kQT = kQW * kWarps;
  const int pd = padded_depth(D);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float acc[kQW][kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kQW; ++i)
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.f;

  // Block-collective when it starts a tile (masked: the tile's row ids are
  // read into their buffer, behind a barrier, before the first copy).
  auto issue = [&](int t) {
    unsigned char* st = smem + (t % kStages) * stage_bytes;
    const int tile = t / n_slices;
    const int e0 = (t_begin + tile) * kTileRows;
    int* ids = nullptr;
    if constexpr (kMasked) {
      ids = ids_all + tile % kIdBufs * kTileRows;
      if (t % n_slices == 0) {
        ids[tid] = e0 + tid < e_end ? rows[e0 + tid] : 0;
        __syncthreads();
      }
    }
    stage_slice<kQuant>(st, resident ? nullptr : reinterpret_cast<float*>(st + bank_stage),
                        bank_v, q, e0, e_end, ids, (t % n_slices) * kSlice, D, q0, Q, kQT,
                        vec, qvec);
  };
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_steps) issue(t);
    cp_async_commit();
  }
  __syncthreads();   // the caller's state (and resident queries not copied by cp.async)

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

    // the tile's scores are complete
    const int tile = t / n_slices;
    tile_done(tile, (t_begin + tile) * kTileRows,
              kMasked ? ids_all + tile % kIdBufs * kTileRows : nullptr, acc);
#pragma unroll
    for (int i = 0; i < kQW; ++i)
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.f;
  }
}

// `list` (masked) holds each query tile's compacted rows, list_stride
// apart, and `list_len` their lengths; both are unused when unmasked.
template <bool kMasked, bool kQuant, int kQW>
__global__ void __launch_bounds__(kThreads, 1)
topk_scan_kernel(const float* __restrict__ q, const void* __restrict__ bank_v,
                 const float* __restrict__ scales, const int* __restrict__ q_ns,
                 const int* __restrict__ bank_ns, const int* __restrict__ list,
                 const int* __restrict__ list_len, int list_stride, int Q, int D,
                 int n_valid, int k, int n_chunks, bool resident, bool vec, bool qvec,
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
  int* ids_all = flush_at + 2;                   // masked: [kIdBufs][256] row ids

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* ws = ws_all + warp * kTileRows;   // this warp's tile scratch
  int* wr = wr_all + warp * kTileRows;
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * kQT;
  const int* rows = kMasked ? list + (size_t)blockIdx.y * list_stride : nullptr;
  const int n_entries = kMasked ? list_len[blockIdx.y] : n_valid;
  const int n_tiles = (n_entries + kTileRows - 1) / kTileRows;
  const int t_end = (int)((long long)(chunk + 1) * n_tiles / n_chunks);
  // a sample pass scans the last tile of each chunk, if chunks are long
  const int t_begin = !sample ? (int)((long long)chunk * n_tiles / n_chunks)
                      : n_tiles >= kSampleRatio * n_chunks ? t_end - 1 : t_end;
  const int e_end = min(n_entries, t_end * kTileRows);
  const int n_slices = max(1, (D + kSlice - 1) / kSlice);
  const int n_steps = (t_end - t_begin) * n_slices;
  if (n_steps == 0) {   // no tile: empty lists, one empty entry each
    for (int i = tid; i < kQT && q0 + i < Q; i += kThreads) {
      const size_t base = ((size_t)(q0 + i) * n_chunks + chunk) * k;
      part_s[base] = -CUDART_INF_F;
      part_r[base] = kPadRow;
    }
    return;
  }

  for (int i = tid; i < kQT * k; i += kThreads) {
    ls[i] = -CUDART_INF_F;
    lr[i] = kPadRow;
  }
  if (tid < 2) flush_at[tid] = -1;
  if (resident) load_queries<kQT>(qres, q, Q, D, q0, qvec);
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

  // select, warp by warp, each tile's complete scores
  scan_tiles<kMasked, kQuant, kQW>(
      smem, stage_bytes, bank_stage, conv, qres, ids_all, q, bank_v, rows, Q, D, q0, t_begin,
      e_end, n_steps, n_slices, resident, vec, qvec,
      [&](int tile, int e0, const int* ids, float (&acc)[kQW][kRowsPerLane]) {
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
          const bool live = e0 + lane + 32 * j < e_end;
          const int row = kMasked ? ids[lane + 32 * j] : e0 + lane + 32 * j;
          scl[j] = (kQuant && live) ? scales[row] : 0.f;
          lab[j] = (kMasked && live) ? bank_ns[row] : 0;
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
              bool ok = e0 + lane + 32 * j < e_end && sv[j] > thr[i] && sv[j] >= fl[i];
              if constexpr (kMasked) ok = ok && lab[j] == qns[i];
              if (!ok) sv[j] = -CUDART_INF_F;
              c += __popc(__ballot_sync(kFull, ok));
            }
            if (c > 0) {   // warp-uniform
#pragma unroll
              for (int j = 0; j < kRowsPerLane; ++j) ws[32 * j + lane] = sv[j];
              cnt[i] = admit(qls, qlr, k, qbs, qbr, cnt[i], ws, wr, c, e0, ids);
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
      });

  // each list's live entries and the empty entry after them (if any): the
  // merge pass reads no further
#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    const int qi = warp * kQW + i;
    if (q0 + qi >= Q) continue;   // warp-uniform
    if (cnt[i] > 0)
      sort_merge<kBuf / 32>(ls + qi * k, lr + qi * k, k, bs + qi * kBuf, br + qi * kBuf, cnt[i],
                            cnt[i]);
    const size_t base = ((size_t)(q0 + qi) * n_chunks + chunk) * k;
    for (int e = lane; e < k; e += 32) {
      if (e > 0 && lr[qi * k + e - 1] == kPadRow) break;
      part_s[base + e] = ls[qi * k + e];
      part_r[base + e] = lr[qi * k + e];
    }
  }
}

// Pass 2's dynamic shared memory: one list and one scratch segment a warp.
size_t merge_lists_smem_bytes(int k) {
  return (sizeof(float) + sizeof(int)) * (size_t)kWarps * (k + kSeg);
}

// floor_out: a sample pass's merge, which writes each query's floor key
// only.  list_len (masked) holds the query tiles' compacted lengths (qt
// queries a tile), from which a sample pass's merge sees, as its scan
// kernel did, whether the sample ran.
__global__ void __launch_bounds__(kThreads)
topk_merge_lists_kernel(const float* __restrict__ part_s, const int* __restrict__ part_r,
                        int k, int n_chunks, float* __restrict__ out_s,
                        int* __restrict__ out_i, unsigned* __restrict__ floor_out,
                        const int* __restrict__ list_len, int qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ls = reinterpret_cast<float*>(smem);              // [kWarps][k]
  int* lr = reinterpret_cast<int*>(ls + kWarps * k);
  float* ss = reinterpret_cast<float*>(lr + kWarps * k);   // [kWarps][kSeg]
  int* sr = reinterpret_cast<int*>(ss + kWarps * kSeg);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int qq = blockIdx.x;
  if (floor_out != nullptr && list_len != nullptr &&
      (list_len[qq / qt] + kTileRows - 1) / kTileRows < kSampleRatio * n_chunks) {
    if (tid == 0) floor_out[qq] = 0u;   // no sample: no floor
    return;
  }
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


// ---------------------------------------------------------------------------
// The large-k path: k > kScanMaxK.  The scan kernel keeps a query tile's
// lists in shared memory, which bounds k at 2,048; the reference's kernel
// answers any k.  Past that bound each call runs, per chunk of queries
// (sized by the wrapper so that the workspace stays within a few hundred
// MB: 64 queries of a 2^20-row bank hold 256 MiB of keys):
//
//   plan, [count,     masked: the chunk's queries grouped by label
//   compact],         (topk_group_plan_kernel, one CTA): a label that at
//   offsets           least kGroupMin queries ask gets 32-query tiles of its
//                     own, the rest share tiles in label order; then the
//                     label compaction of each such tile (the scan kernel's
//                     compaction bodies, one block a row block looping over
//                     the tiles, which also copies the tiles' query rows
//                     together) and the tiles' key offsets and score CTAs,
//                     in proportion to their listed rows
//                     (topk_group_offsets_kernel).  A tile then lists about
//                     its own queries' rows, not the union of 64 queries'
//                     labels;
//   score             topk_score_kernel<kMasked, kQuant>: the scan kernel's
//                     main loop (scan_tiles: the same ring, the same fmaf
//                     chain, so the same score bits; 8 queries a warp
//                     unmasked, 4 masked), writing each (query, entry)
//                     score as its 32-bit order-preserving key (0 for an
//                     entry whose label differs) to the workspace: query q
//                     of a grouped tile holds its tile's entries at its own
//                     offset, so the keys take each tile's rows x queries;
//   hist              the first radix digit (11 bits) of every live key, one
//                     histogram a query;
//   pick, pass 0      one CTA a query picks the bin holding its k-th key
//                     (with fewer live keys than k the query takes them
//                     all; else the bin's count sets its mode: `filtered`
//                     when it fits the candidate buffer of `cap` entries,
//                     `heavy` when it does not), then one more read of the
//                     keys filters them (AIR Top-K's filter, Zhang et al.,
//                     SC'23): a key above the pivot bin goes straight to
//                     the survivors; a key inside it is counted by the next
//                     digit and, filtered, copied with its row to the
//                     candidate buffer;
//   pick, pass 1,     filtered: the second digit's bin splits the
//   pick, pass 2      candidates into survivors and second candidates
//                     (counted by the third digit), whose keys at or above
//                     the k-th key T then join the survivors -- the top-k
//                     and every key tied with T, so the sort decides the
//                     ties by row.  Heavy (a pivot bin past the buffer, as
//                     on an all-tied bank): the third digit's histogram
//                     over the keys, then each block's pivot-bin keys above
//                     T and equal to it;
//   select write      heavy only: the bin's keys above T and the lowest
//                     entries equal to it (entries ascend with the row),
//                     compacted in entry order by the per-block counts and
//                     a block scan;
//   sort runs,        survivors as 64-bit sort keys (~key << 32 | row:
//   merge runs x r    ascending = score desc, row asc), sorted in runs of
//                     16,384 in shared memory (16 keys a thread sorted in
//                     registers, then merge-path rounds in shared memory),
//                     then up to r = ceil(log2(runs)) merge rounds: each CTA
//                     splits its 8,192 outputs of a pair of runs by a
//                     merge-path search (a warp's 32-way search in device
//                     memory), copies both input ranges into shared memory
//                     coalesced and merges them there.  The stage that
//                     completes a query's sort writes its outputs: (score,
//                     row) of the first k, and (NEG_INF, -1) past the
//                     survivors.
//
// What bounds it: the function needs the product and one read of the bank,
// as the scan kernel.  This design adds the workspace's traffic -- one
// write and two reads of each query's 4-byte keys (a heavy query four
// more), the candidates (8 bytes each, written once and read once, twice
// for the second ones) and the survivors' 8-byte keys (written once, read
// and written by the run sort and each merge round).  At Q = 64, N = 2^20 the keys are 256 MiB,
// ~0.24 ms of HBM traffic beside the product's 0.51 ms.
// No library sort, select or product runs: every pass is written here.
// ---------------------------------------------------------------------------

constexpr int kLargeQW = 8;                     // the unmasked score pass's queries a warp
constexpr int kLargeQT = kLargeQW * kWarps;     // and a CTA
constexpr int kGroupQW = 4;                     // the masked score pass's queries a warp
constexpr int kGroupQT = kGroupQW * kWarps;     // and a CTA: one grouped tile
constexpr int kGroupMin = 8;                    // queries of one label that get own tiles
constexpr int kPlanMax = 1024;                  // a masked chunk's queries (one plan CTA)
constexpr int kPlanTilesMax = (kPlanMax + kGroupQT - 1) / kGroupQT + kPlanMax / kGroupMin;
constexpr int kRadixBins = 2048;                // the widest digit's bins
constexpr int kSelectBatch = kThreads * 4;      // entries a block takes at once
constexpr int kSortThreads = 1024;
constexpr int kSortElems = 16;                  // keys a sort thread holds
constexpr int kSortRun = kSortThreads * kSortElems;   // keys one CTA sorts
constexpr int kMergeThreads = 512;
constexpr int kMergeTile = kMergeThreads * kSortElems;   // outputs a merge CTA makes
constexpr int kBlocksPerSm = 8;                 // select/histogram CTAs an SM
constexpr int kCandShare = 16;                  // candidate buffer: n_valid / 16 a query

static_assert(kLargeQT <= kMaxTileQueries && kGroupQT <= kMaxTileQueries,
              "a score CTA's queries fit the compaction's label buffers");
static_assert(kRadixBins % kThreads == 0, "the pick gives each thread whole bins");
static_assert(kSelectBatch <= 0xffff, "a batch's counts pack into 16 bits");

// Pass p's digit: its width and its shift, from the key's top.
__host__ __device__ constexpr int radix_bits(int pass) { return pass < 2 ? 11 : 10; }
__host__ __device__ constexpr int radix_shift(int pass) {
  return pass == 0 ? 21 : pass == 1 ? 10 : 0;
}

// The sort/merge key of entry `row` with rank key `key`: ascending order is
// (score desc, row asc).
__device__ __forceinline__ unsigned long long sort_key(unsigned key, int row) {
  return ((unsigned long long)(~key) << 32) | (unsigned)row;
}

// The rank key of a live score: score_key with -0 taken as +0 (they tie as
// floats), so never 0, the key of an entry whose label differs.
__device__ __forceinline__ unsigned rank_key(float s) {
  return score_key(s == 0.f ? 0.f : s);
}

// Candidate buffer entries a query: n_valid / kCandShare, at least k, at
// most n_valid.  A pivot bin holding more runs the heavy select.
__host__ __device__ inline int large_cap(int n_valid, int k) {
  return min(n_valid, max(k, (n_valid + kCandShare - 1) / kCandShare));
}

// Survivor sort keys a query: every key above the k-th plus at most the
// candidates, never more than the live entries.
__host__ __device__ inline int large_stride(int n_valid, int k) {
  return (int)min((long long)n_valid, (long long)k + large_cap(n_valid, k));
}

// A masked chunk of qc queries has at most this many grouped tiles:
// ceil(qc / kGroupQT) packed, plus one per label of kGroupMin or more.
__host__ __device__ inline int group_tiles_max(int qc) {
  return (qc + kGroupQT - 1) / kGroupQT + qc / kGroupMin;
}

// Where each query's keys are.  Unmasked (null arrays): query q's n_valid
// entries at q * n_valid, entry e is row e.  Masked: at first[q], count[q]
// entries, entry e is row list[tile[q] * n_valid + e].
struct Entries {
  const long long* first;
  const int* count;
  const int* tile;
  const int* list;
  int n_valid;
  __device__ long long at(int q) const { return first ? first[q] : (long long)q * n_valid; }
  __device__ int n(int q) const { return count ? count[q] : n_valid; }
  __device__ const int* rows(int q) const {
    return list ? list + (size_t)tile[q] * n_valid : nullptr;
  }
};

// The grouped tiles of a masked score pass: slot s = tile * kGroupQT + i
// holds query slot_query[s] (-1: empty) of label slot_ns[s]; the tile's
// CTAs are chunk_off[tile] .. chunk_off[tile + 1] - 1, its compacted rows
// list + tile * n_valid (list_len[tile] of them), its queries' keys at
// first[query].
struct GroupPlan {
  const int* slot_query;
  const int* slot_ns;
  const int* n_tiles;
  const int* chunk_off;
  const int* list;
  const int* list_len;
  const long long* first;
};

// Exclusive scan of v over a block of kBlock (<= 1024) threads; *total
// gets the sum.  Block-collective; warp_sum (kBlock / 32 ints) is free
// again when it returns.
template <int kBlock>
__device__ __forceinline__ int block_scan(int v, int* warp_sum, int* total) {
  constexpr int kW = kBlock / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kW ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kW) warp_sum[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sum[warp - 1] : 0) + incl - v;
  *total = warp_sum[kW - 1];
  __syncthreads();
  return before;
}

// One CTA: the tile plan of a masked chunk's qc (<= kPlanMax) queries.
// Queries in label order (ties by index); a label asked by >= kGroupMin
// queries fills tiles of its own (kGroupQT queries each), in label order;
// the rest follow, packed kGroupQT a tile.  Slots no query fills are -1.
// Writes slot_query/slot_ns (tiles_max tiles) and the tile count.
__global__ void __launch_bounds__(kPlanMax)
topk_group_plan_kernel(const int* __restrict__ q_ns, int qc, int tiles_max,
                       int* __restrict__ slot_query, int* __restrict__ slot_ns,
                       int* __restrict__ n_tiles) {
  __shared__ int lab[kPlanMax], q_at[kPlanMax], g_first[kPlanMax], g_size[kPlanMax];
  __shared__ int tile_of_head[kPlanMax];
  __shared__ int warp_sum[kPlanMax / 32];
  const int tid = threadIdx.x;
  for (int s = tid; s < tiles_max * kGroupQT; s += kPlanMax) slot_query[s] = -1;
  if (tid < qc) lab[tid] = q_ns[tid];
  __syncthreads();
  if (tid < qc) {   // this query's place in label order, and its label's group
    const int v = lab[tid];
    int less = 0, same = 0, same_before = 0;
    for (int j = 0; j < qc; ++j) {
      const int u = lab[j];
      less += u < v ? 1 : 0;
      same += u == v ? 1 : 0;
      same_before += (u == v && j < tid) ? 1 : 0;
    }
    const int p = less + same_before;
    q_at[p] = tid;
    g_first[p] = less;
    g_size[p] = same;
  }
  __syncthreads();
  // thread p: place p.  A head of a big group adds its tiles; a place of a
  // small group adds one to the rest (16 bits each, packed)
  const bool live = tid < qc;
  const bool big = live && g_size[tid] >= kGroupMin;
  const int own = big && g_first[tid] == tid ? (g_size[tid] + kGroupQT - 1) / kGroupQT : 0;
  int total;
  const int before =
      block_scan<kPlanMax>((own << 16) | (live && !big ? 1 : 0), warp_sum, &total);
  const int big_tiles = total >> 16;
  if (own > 0) tile_of_head[tid] = before >> 16;
  __syncthreads();
  if (live) {
    int tile, lane;
    if (big) {
      const int i = tid - g_first[tid];
      tile = tile_of_head[g_first[tid]] + i / kGroupQT;
      lane = i % kGroupQT;
    } else {
      const int r = before & 0xffff;
      tile = big_tiles + r / kGroupQT;
      lane = r % kGroupQT;
    }
    const int q = q_at[tid];
    slot_query[tile * kGroupQT + lane] = q;
    slot_ns[tile * kGroupQT + lane] = lab[q];
  }
  if (tid == 0) *n_tiles = big_tiles + ((total & 0xffff) + kGroupQT - 1) / kGroupQT;
}

// The labels of grouped tile t (its filled slots, a prefix of the tile),
// sorted into lab; returns their count.  Block-collective.
__device__ int group_labels(const int* slot_query, const int* slot_ns, int t, int* raw,
                            int* lab) {
  const int s0 = t * kGroupQT;
  const int n = __syncthreads_count(threadIdx.x < kGroupQT && slot_query[s0 + threadIdx.x] >= 0);
  sort_labels(slot_ns + s0, n, raw, lab);
  return n;
}

// The compaction's count pass over the grouped tiles: one block per row
// block, looping over the plan's tiles (whose count only the device
// knows); the blocks also copy the tiles' query rows to q_tiles
// ([tile][kGroupQT][D], zero in empty slots), so that the score pass reads
// a tile's queries together.
__global__ void __launch_bounds__(kThreads)
topk_group_count_kernel(const float* __restrict__ q, int D, const int* __restrict__ slot_query,
                        const int* __restrict__ slot_ns, const int* __restrict__ n_tiles,
                        const int* __restrict__ bank_ns, int n_valid, float* __restrict__ q_tiles,
                        int* __restrict__ counts) {
  __shared__ int raw[kMaxTileQueries], lab[kMaxTileQueries], warp_sum[kWarps];
  const int nt = *n_tiles;
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    const size_t s0 = (size_t)t * kGroupQT;
    for (int i = threadIdx.x; i < kGroupQT * D; i += kThreads) {
      const int qq = slot_query[s0 + i / D];
      q_tiles[s0 * D + i] = qq >= 0 ? q[(size_t)qq * D + i % D] : 0.f;
    }
  }
  for (int t = 0; t < nt; ++t) {
    const int n = group_labels(slot_query, slot_ns, t, raw, lab);
    count_rows(bank_ns, n_valid, lab, n, t, warp_sum, counts);
  }
}

__global__ void __launch_bounds__(kThreads)
topk_group_compact_kernel(const int* __restrict__ slot_query, const int* __restrict__ slot_ns,
                          const int* __restrict__ n_tiles, const int* __restrict__ bank_ns,
                          int n_valid, const int* __restrict__ counts, int* __restrict__ list,
                          int* __restrict__ list_len) {
  __shared__ int raw[kMaxTileQueries], lab[kMaxTileQueries], warp_sum[kWarps];
  __shared__ int staged[kCompactBatch];
  const int nt = *n_tiles;
  for (int t = 0; t < nt; ++t) {
    const int n = group_labels(slot_query, slot_ns, t, raw, lab);
    compact_rows(bank_ns, n_valid, lab, n, t, counts, list, n_valid, list_len, warp_sum, staged);
  }
}

// One CTA, after the compaction: tile t's keys follow tile t-1's (its
// queries x its entries), its score CTAs are in proportion to its 256-row
// tiles of entries (at least one if it has any, at most one a 256-row
// tile, score_ctas in all when the tiles with entries are fewer); each
// query's first key, entry count and tile.
__global__ void __launch_bounds__(kThreads)
topk_group_offsets_kernel(const int* __restrict__ slot_query, const int* __restrict__ n_tiles,
                          const int* __restrict__ list_len, int score_ctas,
                          long long* __restrict__ first, int* __restrict__ count,
                          int* __restrict__ tile_of, int* __restrict__ chunk_off) {
  __shared__ long long key_off[kPlanTilesMax];
  __shared__ int queries[kPlanTilesMax], entries[kPlanTilesMax];
  const int tid = threadIdx.x;
  const int nt = *n_tiles;
  for (int t = tid; t < nt; t += kThreads) {
    int c = 0;
    for (int i = 0; i < kGroupQT; ++i) c += slot_query[t * kGroupQT + i] >= 0 ? 1 : 0;
    queries[t] = c;
    entries[t] = list_len[t];
  }
  __syncthreads();
  if (tid == 0) {
    long long off = 0, row_tiles = 0;
    for (int t = 0; t < nt; ++t) {
      key_off[t] = off;
      off += (long long)queries[t] * entries[t];
      row_tiles += (entries[t] + kTileRows - 1) / kTileRows;
    }
    // one CTA each tile with entries, the rest in proportion (rounded
    // down, so that the CTAs fit the card at once)
    int busy = 0;
    for (int t = 0; t < nt; ++t) busy += entries[t] > 0 ? 1 : 0;
    const long long spare = max(0, score_ctas - busy);
    int c = 0;
    for (int t = 0; t < nt; ++t) {
      chunk_off[t] = c;
      const long long rt = (entries[t] + kTileRows - 1) / kTileRows;
      if (rt > 0) c += (int)min(rt, 1 + spare * rt / row_tiles);
    }
    chunk_off[nt] = c;
  }
  __syncthreads();
  for (int s = tid; s < nt * kGroupQT; s += kThreads) {
    const int qq = slot_query[s];
    if (qq < 0) continue;
    const int t = s / kGroupQT;
    first[qq] = key_off[t] + (long long)(s % kGroupQT) * entries[t];
    count[qq] = entries[t];
    tile_of[qq] = t;
  }
}

// The score pass's dynamic shared memory: the scan kernel's ring, int8
// conversion tile, resident queries and row-id buffers, without its lists.
size_t score_smem_bytes(bool quant, int D, bool resident, bool masked) {
  const int qt = masked ? kGroupQT : kLargeQT;
  const size_t bank_stage = quant ? (size_t)kTileRows * kSlice
                                  : sizeof(float) * kTileRows * kSliceStride;
  const size_t q_stage = resident ? 0 : sizeof(float) * qt * kSliceStride;
  const size_t conv = quant ? sizeof(float) * kTileRows * kSliceStride : 0;
  const size_t qres = resident ? sizeof(float) * qt * padded_depth(D) : 0;
  const size_t ids = masked ? sizeof(int) * kIdBufs * kTileRows : 0;
  return kStages * (bank_stage + q_stage) + conv + qres + ids;
}

// Unmasked: one CTA per (chunk of entry tiles, 64-query tile), keys at
// keys[query * n_valid + entry].  Masked: CTA b runs chunk b - chunk_off[t]
// of grouped tile t (4 queries a warp, the tile's rows copied together in
// q), each query's keys at first[query]; 0 where an entry's label is not
// the query's.  Both through the scan kernel's ring (scan_tiles).
template <bool kMasked, bool kQuant>
__global__ void __launch_bounds__(kThreads, 1)
topk_score_kernel(const float* __restrict__ q, const void* __restrict__ bank_v,
                  const float* __restrict__ scales, const int* __restrict__ bank_ns,
                  GroupPlan plan, int Q, int D, int n_valid, int n_chunks, bool resident,
                  bool vec, bool qvec, unsigned* __restrict__ keys) {
  constexpr int kQW = kMasked ? kGroupQW : kLargeQW;
  constexpr int kQT = kQW * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pd = padded_depth(D);
  const int bank_stage = kQuant ? kTileRows * kSlice
                                : (int)sizeof(float) * kTileRows * kSliceStride;
  const int stage_bytes = bank_stage + (resident ? 0 : (int)sizeof(float) * kQT * kSliceStride);
  float* conv = reinterpret_cast<float*>(smem + kStages * stage_bytes);  // int8 only
  float* qres = conv + (kQuant ? kTileRows * kSliceStride : 0);          // [kQT][pd]
  int* ids_all = reinterpret_cast<int*>(qres + (resident ? kQT * pd : 0));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int tile = blockIdx.y, chunk = blockIdx.x, chunks = n_chunks;
  if constexpr (kMasked) {
    const int nt = *plan.n_tiles;
    const int b = blockIdx.x;
    if (b >= plan.chunk_off[nt]) return;
    int lo = 0, hi = nt;   // the tile whose CTAs hold b
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (plan.chunk_off[mid] <= b) lo = mid;
      else hi = mid;
    }
    tile = lo;
    chunk = b - plan.chunk_off[lo];
    chunks = plan.chunk_off[lo + 1] - plan.chunk_off[lo];
  }
  const int q0 = tile * kQT;
  const int* rows = kMasked ? plan.list + (size_t)tile * n_valid : nullptr;
  const int n_entries = kMasked ? plan.list_len[tile] : n_valid;
  const int n_tiles = (n_entries + kTileRows - 1) / kTileRows;
  const int t_begin = (int)((long long)chunk * n_tiles / chunks);
  const int t_end = (int)((long long)(chunk + 1) * n_tiles / chunks);
  const int e_end = min(n_entries, t_end * kTileRows);
  const int n_slices = max(1, (D + kSlice - 1) / kSlice);
  const int n_steps = (t_end - t_begin) * n_slices;
  if (n_steps == 0) return;

  if (resident) load_queries<kQT>(qres, q, Q, D, q0, qvec);
  int qid[kQW], qns[kQW];   // masked: each slot's query (-1: none) and label
#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    const int s = q0 + warp * kQW + i;
    qid[i] = kMasked ? plan.slot_query[s] : 0;
    qns[i] = kMasked ? plan.slot_ns[s] : 0;
  }
  // each tile's complete scores: their keys to the workspace
  scan_tiles<kMasked, kQuant, kQW>(
      smem, stage_bytes, bank_stage, conv, qres, ids_all, q, bank_v, rows, Q, D, q0, t_begin,
      e_end, n_steps, n_slices, resident, vec, qvec,
      [&](int, int e0, const int* ids, float (&acc)[kQW][kRowsPerLane]) {
        float scl[kRowsPerLane];
        int lab[kRowsPerLane];
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          const bool live = e0 + lane + 32 * j < e_end;
          const int row = kMasked ? ids[lane + 32 * j] : e0 + lane + 32 * j;
          scl[j] = (kQuant && live) ? scales[row] : 0.f;
          lab[j] = (kMasked && live) ? bank_ns[row] : 0;
        }
#pragma unroll
        for (int i = 0; i < kQW; ++i) {
          const int gq = kMasked ? qid[i] : q0 + warp * kQW + i;
          if (kMasked ? gq < 0 : gq >= Q) continue;
          unsigned* out = keys + (kMasked ? plan.first[gq] : (size_t)gq * n_valid);
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) {
            const int e = e0 + lane + 32 * j;
            float s = acc[i][j];
            if constexpr (kQuant) s = s * scl[j];   // after the sum, as the reference
            const bool ok = !kMasked || lab[j] == qns[i];
            if (e < e_end) out[e] = ok ? rank_key(s) : 0u;
          }
        }
      });
}

// A query's select state: the key prefix chosen so far and its mask, how
// many entries with that prefix the top-k still takes, its mode, the first
// digit's prefix (heavy) and where a heavy query's ordered select writes.
enum : int { kModeFiltered = 0, kModeHeavy = 1, kModeAll = 2 };
struct RadixState {
  unsigned prefix;
  unsigned mask;
  int k_rem;
  int mode;
  unsigned bucket0;
  int base;
};

// Entries [begin, end) of a select/histogram block: whole batches of
// kSelectBatch, gridDim.x blocks over a query's n entries.
__device__ __forceinline__ void block_range(int n, int* begin, int* end) {
  const int batches = (n + kSelectBatch - 1) / kSelectBatch;
  const int per = (batches + gridDim.x - 1) / gridDim.x * kSelectBatch;
  *begin = min(n, (int)blockIdx.x * per);
  *end = min(n, *begin + per);
}

// Add one to h[bin] for each lane that takes a key.  Warp-collective.
// Scores crowd a few bins, but a warp's keys rarely share one; when every
// taker does (an all-tied bank), one lane adds them all.
__device__ __forceinline__ void hist_add(unsigned* h, bool take, unsigned bin) {
  const unsigned m = __ballot_sync(kFull, take);
  if (m == 0u) return;
  const unsigned lo = __reduce_min_sync(kFull, take ? bin : 0xffffffffu);
  const unsigned hi = __reduce_max_sync(kFull, take ? bin : 0u);
  if (lo == hi) {
    if ((int)(threadIdx.x & 31) == __ffs(m) - 1) atomicAdd(&h[lo], (unsigned)__popc(m));
  } else if (take) {
    atomicAdd(&h[bin], 1u);
  }
}

// h[(key >> shift) & (bins - 1)] += 1 for each live key of kq[begin, end)
// that carries `prefix` under `mask`, 4 keys in flight a thread.
// Block-collective (the block's threads stride over the range).
__device__ __forceinline__ void count_keys(unsigned* h, const unsigned* kq, int begin, int end,
                                           unsigned mask, unsigned prefix, int shift,
                                           unsigned bins) {
  for (int base = begin; base < end; base += 4 * kThreads) {   // block-uniform
    unsigned key[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = base + j * kThreads + threadIdx.x;
      key[j] = e < end ? kq[e] : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hist_add(h, key[j] != 0u && (key[j] & mask) == prefix, (key[j] >> shift) & (bins - 1u));
  }
}

// The block's nonzero bins of h (`bins` of them) added to dst.
// Block-collective: the barrier first.
__device__ __forceinline__ void flush_hist(const unsigned* h, unsigned bins, unsigned* dst) {
  __syncthreads();
  for (int i = threadIdx.x; i < (int)bins; i += kThreads)
    if (h[i] != 0u) atomicAdd(&dst[i], h[i]);
}

// The first digit's histogram of query blockIdx.y's live keys, summed
// into hist[query][bin].
__global__ void __launch_bounds__(kThreads)
topk_radix_hist_kernel(const unsigned* __restrict__ keys, Entries en,
                       unsigned* __restrict__ hist) {
  __shared__ unsigned h[kRadixBins];
  const int qq = blockIdx.y;
  for (int i = threadIdx.x; i < kRadixBins; i += kThreads) h[i] = 0u;
  __syncthreads();
  int begin, end;
  block_range(en.n(qq), &begin, &end);
  count_keys(h, keys + en.at(qq), begin, end, 0u, 0u, radix_shift(0), kRadixBins);
  flush_hist(h, kRadixBins, hist + (size_t)qq * kRadixBins);
}

// Pass p's pick: from the query's pass-p histogram hq and its state s
// after pass p - 1 (pass 0: from k), the bin that holds its k_rem-th key
// from the top, its digit appended to the prefix and the entries of the
// bins above it taken off k_rem.  Pass 0: with fewer live keys than k the
// query takes them all (kModeAll); else the pivot bin's count sets the
// mode (filtered within `cap`, else heavy).  Pass 2 records where a heavy
// query's ordered select writes (after the survivors so far).
// Block-collective.
__device__ RadixState block_pick(const unsigned* hq, RadixState s, int pass, int k, int cap,
                                 const int* n_surv_q, unsigned* warp_sum, RadixState* picked) {
  if (s.mode == kModeAll) return s;   // block-uniform
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bins = 1 << radix_bits(pass);
  const int per = bins / kThreads;     // thread t owns bins top - t*per down
  const int top = bins - 1 - tid * per;
  unsigned c[kRadixBins / kThreads];
  unsigned mine = 0u;
  for (int j = 0; j < per; ++j) {
    c[j] = hq[top - j];
    mine += c[j];
  }
  // exclusive scan over threads (thread 0 holds the highest bins)
  unsigned incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  unsigned above = incl - mine, total = 0u;
  for (int w = 0; w < kWarps; ++w) {
    above += w < warp ? warp_sum[w] : 0u;
    total += warp_sum[w];
  }
  if (pass == 0 && total < (unsigned)k) {   // fewer live keys than k: all of them
    if (tid == 0) *picked = RadixState{0u, 0u, 0, kModeAll, 0u, 0};
  } else {
    const unsigned want = (unsigned)s.k_rem;
    for (int j = 0; j < per; ++j) {
      if (above < want && above + c[j] >= want) {
        RadixState t = s;
        t.prefix |= (unsigned)(top - j) << radix_shift(pass);
        t.mask |= (unsigned)(bins - 1) << radix_shift(pass);
        t.k_rem = (int)(want - above);
        if (pass == 0) {
          t.bucket0 = t.prefix;
          t.mode = c[j] <= (unsigned)cap ? kModeFiltered : kModeHeavy;
        }
        if (pass == 2) t.base = *n_surv_q;
        *picked = t;
      }
      above += c[j];
    }
  }
  __syncthreads();
  const RadixState out = *picked;
  __syncthreads();   // warp_sum and picked are free again
  return out;
}

// One CTA per query: pass p's pick (`block_pick`) into the query's state.
__global__ void __launch_bounds__(kThreads)
topk_radix_pick_kernel(int k, int cap, int pass, RadixState* __restrict__ state,
                       const unsigned* __restrict__ hist, const int* __restrict__ n_surv) {
  __shared__ unsigned warp_sum[kWarps];
  __shared__ RadixState picked;
  const int qq = blockIdx.x;
  const RadixState s =
      block_pick(hist + (size_t)qq * kRadixBins,
                 pass == 0 ? RadixState{0u, 0u, k, kModeFiltered, 0u, 0} : state[qq], pass, k,
                 cap, n_surv + qq, warp_sum, &picked);
  if (threadIdx.x == 0) state[qq] = s;
}

// A warp's staged survivors or candidates: the first n of buf (kFlushAt
// + 32 entries in shared memory) to their place after the query's count
// (one atomicAdd), coalesced; out-of-range places are dropped (never
// reached: the counts are bounded by the select).  Warp-collective.
constexpr int kStaged = 256;
constexpr int kFlushAt = kStaged - 32;
__device__ __forceinline__ void flush_staged(unsigned long long* buf, int& n, int* count,
                                             unsigned long long* dst, int limit) {
  __syncwarp();
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(count, n);
  base = __shfl_sync(kFull, base, 0);
  for (int i = threadIdx.x & 31; i < n; i += 32)
    if (base + i < limit) dst[base + i] = buf[i];
  n = 0;
  __syncwarp();
}

// One select pass p, per (block, query), after pass p's pick.
//  - Pass 0 reads the query's keys: with kModeAll every live key is a
//    survivor; else a key above the pivot bin is, and a key inside it is
//    counted by the second digit into hist_next and (filtered) copied with
//    its row to the candidates (AIR Top-K's filter).
//  - Pass 1, filtered: the candidates; a key above the second digit's bin
//    is a survivor, one inside it is counted by the third digit and copied
//    to the second candidates.  Heavy: the third digit's histogram of the
//    keys that carry the 22-bit prefix.
//  - Pass 2, filtered: the second candidates; keys at or above the k-th
//    key T are survivors, so the survivors are the top-k and every key
//    tied with T, and the sort decides the ties by row.  Heavy: the
//    block's pivot-bin keys above T and equal to T, into counts, for the
//    ordered select (topk_select_write_kernel).
// The filters take 4 x 32 consecutive entries a warp at a time (4 loads in
// flight a lane) and stage survivors and candidates in shared memory by
// ballots, flushing each past kFlushAt entries with one atomicAdd on the
// query's count (their order does not matter: the sort orders them).
__global__ void __launch_bounds__(kThreads)
topk_select_pass_kernel(const unsigned* __restrict__ keys, Entries en, int pass,
                        const RadixState* __restrict__ state,
                        unsigned* __restrict__ hist_next, const unsigned long long* __restrict__ src,
                        int src_stride, const int* __restrict__ n_src,
                        unsigned long long* __restrict__ cand, int cand_stride,
                        int* __restrict__ n_cand, unsigned long long* __restrict__ surv,
                        int stride, int* __restrict__ n_surv, int* __restrict__ counts) {
  __shared__ unsigned h[kRadixBins];
  __shared__ unsigned long long staged[kWarps][2][kStaged];
  __shared__ int red[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qq = blockIdx.y;
  const RadixState s = state[qq];
  if (pass > 0 && s.mode == kModeAll) return;
  const unsigned* kq = keys + en.at(qq);
  int begin, end;
  if (pass > 0 && s.mode == kModeHeavy) {   // the heavy select's passes over the keys
    block_range(en.n(qq), &begin, &end);
    if (pass == 1) {
      for (int i = tid; i < (1 << radix_bits(2)); i += kThreads) h[i] = 0u;
      __syncthreads();
      count_keys(h, kq, begin, end, s.mask, s.prefix, radix_shift(2), 1u << radix_bits(2));
      flush_hist(h, 1u << radix_bits(2), hist_next + (size_t)qq * kRadixBins);
      return;
    }
    const unsigned T = s.prefix;
    const unsigned b0 = s.bucket0 >> radix_shift(0);
    int above = 0, tie = 0;
    for (int e = begin + tid; e < end; e += kThreads) {
      const unsigned key = kq[e];
      above += key > T && (key >> radix_shift(0)) == b0 ? 1 : 0;
      tie += key == T ? 1 : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      above += __shfl_xor_sync(kFull, above, o);
      tie += __shfl_xor_sync(kFull, tie, o);
    }
    if (lane == 0) {
      red[0][warp] = above;
      red[1][warp] = tie;
    }
    __syncthreads();
    if (tid == 0) {
      int a = 0, t = 0;
      for (int w = 0; w < kWarps; ++w) {
        a += red[0][w];
        t += red[1][w];
      }
      counts[((size_t)qq * gridDim.x + blockIdx.x) * 2] = a;
      counts[((size_t)qq * gridDim.x + blockIdx.x) * 2 + 1] = t;
    }
    return;
  }
  const bool all = s.mode == kModeAll;
  const bool keep = s.mode == kModeFiltered && pass < 2;   // candidates stored
  const bool count = !all && pass < 2;                      // the next digit counted
  const unsigned bins = 1u << radix_bits(pass + 1);
  // the bin boundary of this pass: keys above `top` are survivors, keys
  // whose `shift`-bit prefix equals it are candidates
  const int shift = pass == 0 ? radix_shift(0) : pass == 1 ? radix_shift(1) : 0;
  const unsigned top = pass == 0 ? s.bucket0 >> shift : s.prefix >> shift;
  if (count)
    for (int i = tid; i < (int)bins; i += kThreads) h[i] = 0u;
  __syncthreads();
  block_range(pass == 0 ? en.n(qq) : n_src[qq], &begin, &end);
  const unsigned long long* sq_in = src + (size_t)qq * src_stride;
  const int* rows = en.rows(qq);
  unsigned long long* cq = cand + (size_t)qq * cand_stride;
  unsigned long long* sq = surv + (size_t)qq * stride;
  unsigned long long* st_s = staged[warp][0];
  unsigned long long* st_c = staged[warp][1];
  int ns = 0, nc = 0;   // staged survivors and candidates (warp-uniform)
  const unsigned below = (1u << lane) - 1u;
  for (int base = begin + warp * 128; base < end; base += 4 * kThreads) {   // warp-uniform
    unsigned long long v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = base + 32 * j + lane;
      if (pass == 0) v[j] = e < end ? kq[e] : 0u;
      else v[j] = e < end ? sq_in[e] : ~0ull;   // ~0: the key of no entry
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = base + 32 * j + lane;
      const unsigned key = pass == 0 ? (unsigned)v[j] : ~(unsigned)(v[j] >> 32);
      const unsigned d = key >> shift;
      const bool live = key != 0u;
      const bool is_s = live && (all || d > top || (pass == 2 && d == top));
      const bool inb = live && !all && pass < 2 && d == top;
      const unsigned ms = __ballot_sync(kFull, is_s), mi = __ballot_sync(kFull, inb);
      if ((ms | mi) == 0u) continue;   // most keys lie below the bin
      if (count) hist_add(h, inb, (key >> radix_shift(pass + 1)) & (bins - 1u));
      const unsigned mc = keep ? mi : 0u;
      if (is_s || (keep && inb)) {
        const unsigned long long val =
            pass == 0 ? sort_key(key, rows != nullptr ? rows[e] : e) : v[j];
        if (is_s) st_s[ns + __popc(ms & below)] = val;
        else st_c[nc + __popc(mc & below)] = val;
      }
      ns += __popc(ms);
      nc += __popc(mc);
      if (ns > kFlushAt) flush_staged(st_s, ns, &n_surv[qq], sq, stride);
      if (nc > kFlushAt) flush_staged(st_c, nc, &n_cand[qq], cq, cand_stride);
    }
  }
  if (ns > 0) flush_staged(st_s, ns, &n_surv[qq], sq, stride);
  if (nc > 0) flush_staged(st_c, nc, &n_cand[qq], cq, cand_stride);
  if (count) flush_hist(h, bins, hist_next + (size_t)qq * kRadixBins);
}

// Heavy queries, the ordered select inside the pivot bin: keys of the bin
// above the k-th key T are all taken, then the lowest entries equal to T
// (k_rem of them; entries ascend with the row).  Per (block, query), with
// pass 2's state and per-block counts: the block's bin keys above T at
// their place after the blocks before it (in entry order), then its ties
// after every block's keys above T, as far as the ties taken, all after
// the survivors the filter wrote (state.base).  Each thread tests 4
// consecutive entries of a batch; a block scan of its (above, tie)
// counts, packed 16:16, places them.  Block 0 writes the survivor count.
__global__ void __launch_bounds__(kThreads)
topk_select_write_kernel(const unsigned* __restrict__ keys, Entries en,
                         const RadixState* __restrict__ state, const int* __restrict__ counts,
                         int stride, unsigned long long* __restrict__ surv,
                         int* __restrict__ n_surv) {
  __shared__ int warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int qq = blockIdx.y;
  const RadixState s = state[qq];
  if (s.mode != kModeHeavy) return;
  const unsigned T = s.prefix;
  const unsigned b0 = s.bucket0 >> radix_shift(0);
  int ties = s.k_rem;
  const int* cq = counts + (size_t)qq * gridDim.x * 2;
  // the bin keys above T and the ties of the blocks before this one, and of all
  int a_before = 0, t_before = 0, a_total = 0, t_total = 0;
  for (int b = 0; b < (int)gridDim.x; ++b) {
    const int a = cq[2 * b], t = cq[2 * b + 1];
    a_total += a;
    t_total += t;
    if (b < (int)blockIdx.x) {
      a_before += a;
      t_before += t;
    }
  }
  if (blockIdx.x == 0 && tid == 0) n_surv[qq] = s.base + a_total + min(t_total, ties);
  if (t_before >= ties) ties = 0;   // none of this block's ties is taken
  int begin, end;
  block_range(en.n(qq), &begin, &end);
  const unsigned* kq = keys + en.at(qq);
  const int* rows = en.rows(qq);
  unsigned long long* oq = surv + (size_t)qq * stride + s.base;
  for (int base = begin; base < end; base += kSelectBatch) {
    const int e0 = base + 4 * tid;
    unsigned k4[4];
    unsigned above_bits = 0u, tie_bits = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k4[i] = e0 + i < end ? kq[e0 + i] : 0u;
      if (k4[i] > T && (k4[i] >> radix_shift(0)) == b0) above_bits |= 1u << i;
      else if (ties > 0 && k4[i] == T) tie_bits |= 1u << i;
    }
    int sum;
    const int at =
        block_scan<kThreads>((__popc(above_bits) << 16) | __popc(tie_bits), warp_sum, &sum);
    int a_at = a_before + (at >> 16), t_at = t_before + (at & 0xffff);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows != nullptr ? (e0 + i < end ? rows[e0 + i] : 0) : e0 + i;
      if (above_bits & (1u << i)) oq[a_at++] = sort_key(k4[i], row);
      if (tie_bits & (1u << i)) {
        if (t_at < ties) oq[a_total + t_at] = sort_key(k4[i], row);
        ++t_at;
      }
    }
    a_before += sum >> 16;
    t_before += sum & 0xffff;
  }
}

// ---- the sort: 16,384-key runs in shared memory, merge-path rounds ------

// Shared-memory index of key i: a pad slot after every 16 keys, so that a
// thread's 16 consecutive keys and its neighbours' fall in other banks.
__device__ __forceinline__ int spad(int i) { return i + (i >> 4); }

// Sort 16 keys ascending in registers (a bitonic network).
__device__ __forceinline__ void sort16(unsigned long long (&v)[kSortElems]) {
#pragma unroll
  for (int size = 2; size <= kSortElems; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
      for (int i = 0; i < kSortElems; ++i) {
        const int j = i ^ stride;
        if (j > i && ((v[i] > v[j]) == ((i & size) == 0))) {
          const unsigned long long t = v[i];
          v[i] = v[j];
          v[j] = t;
        }
      }
}

// Merge path: how many of the first d keys of the merge of sorted a[0, la)
// and b[0, lb) come from a (equal keys: a's first).
template <typename A, typename B>
__device__ __forceinline__ int merge_split(A a, int la, B b, int lb, int d) {
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a(mid) <= b(d - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The same split by a warp in device memory: each step tests 32 evenly
// spaced places, so ~4 dependent loads find a split in 65,536 keys.
// Warp-collective; every lane returns it.
__device__ __forceinline__ int warp_merge_split(const unsigned long long* a, int la,
                                                const unsigned long long* b, int lb, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - lb), hi = min(d, la);   // the split is in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + step * lane;
    const bool before = i < hi && a[i] <= b[d - 1 - i];
    const int c = __popc(__ballot_sync(kFull, before));
    const int next_hi = min(hi, lo + step * c);
    lo = c > 0 ? lo + step * (c - 1) + 1 : lo;
    hi = c > 0 ? next_hi : lo;
  }
  return lo;
}

// kSortElems keys of the merge of a[0, la) and b[0, lb) from a's key i and
// b's key j on (past both: ~0).
template <typename A, typename B>
__device__ __forceinline__ void merge_keys(A a, int la, B b, int lb, int i, int j,
                                           unsigned long long (&v)[kSortElems]) {
  unsigned long long x = i < la ? a(i) : ~0ull, y = j < lb ? b(j) : ~0ull;
#pragma unroll
  for (int e = 0; e < kSortElems; ++e) {
    const bool from_a = j >= lb || (i < la && x <= y);
    v[e] = from_a ? x : y;
    if (from_a) {
      ++i;
      x = i < la ? a(i) : ~0ull;
    } else {
      ++j;
      y = j < lb ? b(j) : ~0ull;
    }
  }
}

// The outputs of sorted position e of query qq: (score, row) of its key
// below n, else the fill.
__device__ __forceinline__ void emit(float* out_s, int* out_i, int k, int qq, int e, int n,
                                     unsigned long long key) {
  const size_t o = (size_t)qq * k + e;
  if (e < n) {
    out_s[o] = key_score(~(unsigned)(key >> 32));
    out_i[o] = (int)(unsigned)(key & 0xffffffffull);
  } else {
    out_s[o] = kNegInf;
    out_i[o] = -1;
  }
}

// Each CTA sorts run blockIdx.x (kSortRun keys) of query blockIdx.y's
// n_surv survivors: its keys padded with ~0 to a power of two (at least
// 16), 16 a thread sorted in registers, then merge rounds of doubling
// runs in shared memory, each thread merging its 16 outputs after a
// merge-path split.  A query whose survivors fit one run is done here: its
// outputs, the fill up to k included; the others' runs go back in place.
__global__ void __launch_bounds__(kSortThreads)
topk_sort_runs_kernel(unsigned long long* __restrict__ buf, int stride,
                      const int* __restrict__ n_surv, int k, float* __restrict__ out_s,
                      int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned long long sk[];   // spad(kSortRun)
  const int tid = threadIdx.x;
  const int qq = blockIdx.y;
  const int n = min(n_surv[qq], stride);
  const bool done = n <= kSortRun;   // one run: this CTA writes the outputs
  const int r0 = blockIdx.x * kSortRun;
  if (done ? blockIdx.x > 0 : r0 >= n) return;
  const int len = max(0, min(kSortRun, n - r0));
  int n_pad = kSortElems;
  while (n_pad < len) n_pad <<= 1;
  unsigned long long* bq = buf + (size_t)qq * stride + r0;
  for (int i = tid; i < n_pad; i += kSortThreads) sk[spad(i)] = i < len ? bq[i] : ~0ull;
  __syncthreads();
  const bool active = kSortElems * tid < n_pad;
  unsigned long long v[kSortElems];
  if (active) {
#pragma unroll
    for (int e = 0; e < kSortElems; ++e) v[e] = sk[spad(kSortElems * tid + e)];
    sort16(v);
  }
  for (int run = kSortElems; run < n_pad; run <<= 1) {
    __syncthreads();
    if (active) {
#pragma unroll
      for (int e = 0; e < kSortElems; ++e) sk[spad(kSortElems * tid + e)] = v[e];
    }
    __syncthreads();
    if (active) {
      const int o = kSortElems * tid;
      const int a0 = o / (2 * run) * (2 * run);
      const int d = o - a0;
      auto A = [&](int i) { return sk[spad(a0 + i)]; };
      auto B = [&](int i) { return sk[spad(a0 + run + i)]; };
      const int i = merge_split(A, run, B, run, d);
      merge_keys(A, run, B, run, i, d - i, v);
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int e = 0; e < kSortElems; ++e) sk[spad(kSortElems * tid + e)] = v[e];
  }
  __syncthreads();
  if (done) {
    for (int e = tid; e < k; e += kSortThreads)
      emit(out_s, out_i, k, qq, e, len, e < len ? sk[spad(e)] : 0ull);
  } else {
    for (int i = tid; i < len; i += kSortThreads) bq[i] = sk[spad(i)];
  }
}

// One merge round of sorted runs of `run` keys (a multiple of kSortRun)
// for the queries whose sort is not complete (more than `run` survivors).
// CTA x of query y makes outputs [x kMergeTile, (x+1) kMergeTile) of its
// pair of runs: warps 0 and 1 find where the range starts and ends in each
// run (warp_merge_split), the block copies both input ranges into shared
// memory coalesced, each thread merges its 16 outputs there after a
// merge-path split, and the block writes them coalesced: to dst, or, in
// the round that completes the query's sort (at most 2 run survivors), as
// the outputs, with the fill from n to k (the grid covers max(stride, k)
// outputs).
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_runs_kernel(const unsigned long long* __restrict__ src,
                       unsigned long long* __restrict__ dst, int stride, int run,
                       const int* __restrict__ n_surv, int k, float* __restrict__ out_s,
                       int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned long long sk[];   // spad(kMergeTile)
  __shared__ int split[2];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int qq = blockIdx.y;
  const int n = min(n_surv[qq], stride);
  if (n <= run) return;           // sorted and written by an earlier stage
  const bool last = n <= 2 * run;  // this round completes the sort
  const int o0 = blockIdx.x * kMergeTile;
  if (last)
    for (int e = max(o0, n) + tid; e < min(o0 + kMergeTile, k); e += kMergeThreads)
      emit(out_s, out_i, k, qq, e, n, 0ull);
  if (o0 >= n) return;
  const int pair0 = o0 / (2 * run) * (2 * run);
  const int la = max(0, min(run, n - pair0));
  const int lb = max(0, min(run, n - pair0 - run));
  const int d0 = o0 - pair0;
  const int d1 = min(d0 + kMergeTile, la + lb);
  const unsigned long long* a = src + (size_t)qq * stride + pair0;
  const unsigned long long* b = a + run;
  if (warp < 2) {
    const int s = warp_merge_split(a, la, b, lb, warp == 0 ? d0 : d1);
    if ((tid & 31) == 0) split[warp] = s;
  }
  __syncthreads();
  const int ia = split[0], na = split[1] - split[0];
  const int jb = d0 - split[0], nb = (d1 - split[1]) - jb;
  for (int i = tid; i < na + nb; i += kMergeThreads)
    sk[spad(i)] = i < na ? a[ia + i] : b[jb + i - na];
  __syncthreads();
  const int total = na + nb;
  const int o = kSortElems * tid;
  unsigned long long v[kSortElems];
  if (o < total) {
    auto A = [&](int i) { return sk[spad(i)]; };
    auto B = [&](int i) { return sk[spad(na + i)]; };
    const int i = merge_split(A, na, B, nb, o);
    merge_keys(A, na, B, nb, i, o - i, v);
  }
  __syncthreads();
  if (o < total) {
#pragma unroll
    for (int e = 0; e < kSortElems; ++e)
      if (o + e < total) sk[spad(o + e)] = v[e];
  }
  __syncthreads();
  for (int i = tid; i < total; i += kMergeThreads) {
    if (!last) dst[(size_t)qq * stride + o0 + i] = sk[spad(i)];
    else if (o0 + i < k) emit(out_s, out_i, k, qq, o0 + i, n, sk[spad(i)]);
  }
}

template <bool kMasked, bool kQuant>
const void* score_instance() {
  return reinterpret_cast<const void*>(topk_score_kernel<kMasked, kQuant>);
}

const void* score_kernel(bool masked, bool quant) {
  if (masked) return quant ? score_instance<true, true>() : score_instance<true, false>();
  return quant ? score_instance<false, true>() : score_instance<false, false>();
}

// The large-k workspace of a query chunk, carved in this order (16-byte
// aligned pieces): the keys, the three digits' histograms and the survivor
// and candidate counts (zeroed by one memset), the radix states, the heavy
// select's block counts, the candidates, (masked) the tile plan, the
// tiles' compacted lists with their block counts and lengths and their
// query rows, then the two sort buffers.
struct LargeWorkspace {
  unsigned* keys;
  unsigned* hist;        // [3][qc][kRadixBins]
  int* n_surv;
  int* n_cand;           // [2][qc]: the candidates of passes 0 and 1
  size_t zero_bytes;     // hist .. n_cand
  RadixState* state;
  int* counts;
  unsigned long long* cand;
  int* slot_query;
  int* slot_ns;
  int* n_tiles;
  int* chunk_off;
  long long* first;
  int* count;
  int* tile_of;
  int* list;
  int* list_counts;
  int* list_len;
  float* q_tiles;
  unsigned long long* sort_a;
  unsigned long long* sort_b;
  int blocks;   // select/histogram blocks a query
  int tiles;    // grouped tiles (masked)
  size_t bytes;
};

int select_blocks(int qc, int n_valid, int sms) {
  const int want = (kBlocksPerSm * sms + qc - 1) / qc;
  const int most = max(1, (n_valid + kSelectBatch - 1) / kSelectBatch);
  return max(1, min(want, most));
}

LargeWorkspace carve_large(void* base, int qc, int n_valid, int k, bool masked, int D, int sms) {
  LargeWorkspace w{};
  size_t at = 0;
  auto take = [&](size_t bytes) {
    void* p = base == nullptr ? nullptr : static_cast<unsigned char*>(base) + at;
    at += (bytes + 15) / 16 * 16;
    return p;
  };
  const int cap = large_cap(n_valid, k);
  const int stride = large_stride(n_valid, k);
  w.keys = static_cast<unsigned*>(take(sizeof(unsigned) * (size_t)qc * n_valid));
  const size_t zero0 = at;
  w.hist = static_cast<unsigned*>(take(sizeof(unsigned) * 3 * (size_t)qc * kRadixBins));
  w.n_surv = static_cast<int*>(take(sizeof(int) * (size_t)qc));
  w.n_cand = static_cast<int*>(take(sizeof(int) * 2 * (size_t)qc));
  w.zero_bytes = at - zero0;
  w.state = static_cast<RadixState*>(take(sizeof(RadixState) * (size_t)qc));
  w.blocks = select_blocks(qc, n_valid, sms);
  w.counts = static_cast<int*>(take(sizeof(int) * 2 * (size_t)qc * w.blocks));
  w.cand = static_cast<unsigned long long*>(take(sizeof(unsigned long long) * (size_t)qc * cap));
  if (masked) {
    const int t = w.tiles = group_tiles_max(qc);
    w.slot_query = static_cast<int*>(take(sizeof(int) * (size_t)t * kGroupQT));
    w.slot_ns = static_cast<int*>(take(sizeof(int) * (size_t)t * kGroupQT));
    w.n_tiles = static_cast<int*>(take(sizeof(int)));
    w.chunk_off = static_cast<int*>(take(sizeof(int) * (size_t)(t + 1)));
    w.first = static_cast<long long*>(take(sizeof(long long) * (size_t)qc));
    w.count = static_cast<int*>(take(sizeof(int) * (size_t)qc));
    w.tile_of = static_cast<int*>(take(sizeof(int) * (size_t)qc));
    w.list = static_cast<int*>(take(sizeof(int) * (size_t)t * n_valid));
    w.list_counts = static_cast<int*>(take(sizeof(int) * (size_t)t * compact_blocks(n_valid)));
    w.list_len = static_cast<int*>(take(sizeof(int) * (size_t)t));
    w.q_tiles = static_cast<float*>(take(sizeof(float) * (size_t)t * kGroupQT * D));
  }
  w.sort_a = static_cast<unsigned long long*>(take(sizeof(unsigned long long) * (size_t)qc * stride));
  w.sort_b = static_cast<unsigned long long*>(take(sizeof(unsigned long long) * (size_t)qc * stride));
  w.bytes = at;
  return w;
}

constexpr size_t kSortSmem = sizeof(unsigned long long) * (kSortRun + kSortRun / 16);
constexpr size_t kMergeSmem = sizeof(unsigned long long) * (kMergeTile + kMergeTile / 16);

// Raise the score instances' and the sort kernels' shared-memory ceilings,
// once per device.
cudaError_t raise_large_ceilings() {
  static int done_device = -1;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device == done_device) return err;
  for (int m = 0; m < 2; ++m)
    for (int qn = 0; qn < 2; ++qn)
      if ((err = cudaFuncSetAttribute(score_kernel(m, qn),
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kSmemMax)) != cudaSuccess)
        return err;
  if ((err = cudaFuncSetAttribute(reinterpret_cast<const void*>(topk_sort_runs_kernel),
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kSortSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(reinterpret_cast<const void*>(topk_merge_runs_kernel),
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kMergeSmem)) != cudaSuccess)
    return err;
  done_device = device;
  return cudaSuccess;
}

// Every pass of the large-k path for queries [0, qc) of the pointers given
// (a chunk of the call's queries), on stream st.
cudaError_t large_chunk(const float* q, const void* bank, const float* scales,
                        const int* q_ns, const int* bank_ns, int qc, int D, int n_valid, int k,
                        bool masked, bool quant, const LargeWorkspace& w, int sms,
                        float* out_s, int* out_i, cudaStream_t st) {
  cudaError_t err;
  const int cap = large_cap(n_valid, k);
  const int stride = large_stride(n_valid, k);
  if (n_valid == 0) {   // nothing live: every slot is the fill
    if ((err = cudaMemsetAsync(w.n_surv, 0, sizeof(int) * qc, st)) != cudaSuccess) return err;
    topk_sort_runs_kernel<<<dim3(1, qc), kSortThreads, kSortSmem, st>>>(w.sort_a, 1, w.n_surv, k,
                                                                       out_s, out_i);
    return cudaGetLastError();
  }
  // the score pass: as many CTAs as fit on the card at once
  const bool resident = score_smem_bytes(quant, D, true, masked) <= (size_t)kSmemMax;
  const size_t smem = score_smem_bytes(quant, D, resident, masked);
  const void* score = score_kernel(masked, quant);
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, score, kThreads, smem)) !=
      cudaSuccess)
    return err;
  const int score_ctas = max(1, per_sm) * sms;
  GroupPlan plan{};
  Entries en{nullptr, nullptr, nullptr, nullptr, n_valid};
  const float* qs = q;
  int n_q = qc;
  dim3 sgrid;
  int n_chunks = 0;
  if (masked) {
    const int t = w.tiles;
    topk_group_plan_kernel<<<1, kPlanMax, 0, st>>>(q_ns, qc, t, w.slot_query, w.slot_ns,
                                                    w.n_tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int cgrid = compact_blocks(n_valid);
    topk_group_count_kernel<<<cgrid, kThreads, 0, st>>>(q, D, w.slot_query, w.slot_ns, w.n_tiles,
                                                        bank_ns, n_valid, w.q_tiles,
                                                        w.list_counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    topk_group_compact_kernel<<<cgrid, kThreads, 0, st>>>(w.slot_query, w.slot_ns, w.n_tiles,
                                                          bank_ns, n_valid, w.list_counts,
                                                          w.list, w.list_len);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    topk_group_offsets_kernel<<<1, kThreads, 0, st>>>(w.slot_query, w.n_tiles, w.list_len,
                                                      score_ctas, w.first, w.count, w.tile_of,
                                                      w.chunk_off);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    plan = GroupPlan{w.slot_query, w.slot_ns, w.n_tiles, w.chunk_off, w.list, w.list_len,
                     w.first};
    en = Entries{w.first, w.count, w.tile_of, w.list, n_valid};
    qs = w.q_tiles;
    n_q = t * kGroupQT;
    sgrid = dim3(score_ctas + t, 1);
  } else {
    const int tiles = (qc + kLargeQT - 1) / kLargeQT;
    const int n_tiles = (n_valid + kTileRows - 1) / kTileRows;
    n_chunks = max(1, min((score_ctas + tiles - 1) / tiles, n_tiles));
    sgrid = dim3(n_chunks, tiles);
  }
  const uintptr_t qa = reinterpret_cast<uintptr_t>(qs);
  const uintptr_t ba = reinterpret_cast<uintptr_t>(bank);
  bool vec = quant ? (D % 16 == 0 && ba % 16 == 0) : (D % 4 == 0 && ba % 16 == 0);
  bool qvec = D % 4 == 0 && qa % 16 == 0;
  bool res = resident;
  void* args[] = {(void*)&qs,   (void*)&bank,     (void*)&scales, (void*)&bank_ns,
                  (void*)&plan, (void*)&n_q,      (void*)&D,      (void*)&n_valid,
                  (void*)&n_chunks, (void*)&res,  (void*)&vec,    (void*)&qvec,
                  (void*)&w.keys};
  if ((err = cudaLaunchKernel(score, sgrid, dim3(kThreads), args, smem, st)) != cudaSuccess)
    return err;
  // the radix select: the first digit's histogram, then three passes, each
  // after its digit's pick (pass 0: keys -> survivors and candidates; pass
  // 1: candidates -> survivors and second candidates, in sort_b, idle
  // until the merges; pass 2: those -> survivors), a heavy query's passes
  // 1 and 2 counting its keys for the ordered select instead
  const dim3 grid(w.blocks, qc);
  const size_t hq = (size_t)qc * kRadixBins;
  if ((err = cudaMemsetAsync(w.hist, 0, w.zero_bytes, st)) != cudaSuccess) return err;
  topk_radix_hist_kernel<<<grid, kThreads, 0, st>>>(w.keys, en, w.hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int pass = 0; pass < 3; ++pass) {
    topk_radix_pick_kernel<<<qc, kThreads, 0, st>>>(k, cap, pass, w.state, w.hist + pass * hq,
                                                    w.n_surv);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const unsigned long long* src = pass == 1 ? w.cand : w.sort_b;
    const int src_stride = pass == 1 ? cap : stride;
    unsigned long long* cand = pass == 0 ? w.cand : pass == 1 ? w.sort_b : nullptr;
    const int cand_stride = pass == 0 ? cap : stride;
    topk_select_pass_kernel<<<grid, kThreads, 0, st>>>(
        w.keys, en, pass, w.state, pass < 2 ? w.hist + (pass + 1) * hq : nullptr, src, src_stride,
        pass > 0 ? w.n_cand + (pass - 1) * qc : nullptr, cand, cand_stride,
        pass < 2 ? w.n_cand + pass * qc : nullptr, w.sort_a, stride, w.n_surv, w.counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  topk_select_write_kernel<<<grid, kThreads, 0, st>>>(w.keys, en, w.state, w.counts, stride,
                                                      w.sort_a, w.n_surv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the sort: runs in shared memory, then merge rounds; the last stage
  // writes the outputs
  const int runs = (stride + kSortRun - 1) / kSortRun;
  topk_sort_runs_kernel<<<dim3(runs, qc), kSortThreads, kSortSmem, st>>>(w.sort_a, stride,
                                                                       w.n_surv, k, out_s, out_i);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  unsigned long long* src = w.sort_a;
  unsigned long long* dst = w.sort_b;
  const int outs = max(stride, k);   // any round may write a query's outputs
  for (int run = kSortRun; run < stride; run *= 2) {
    topk_merge_runs_kernel<<<dim3((outs + kMergeTile - 1) / kMergeTile, qc), kMergeThreads,
                             kMergeSmem, st>>>(src, dst, stride, run, w.n_surv, k, out_s, out_i);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The scan kernel's dynamic shared memory for a query tile of
// `queries_per_tile` queries (bytes).
size_t topk_mips_scan_smem_bytes(int k, int quant, int D, int queries_per_tile,
                                 int resident, int masked) {
  return scan_smem_bytes(k, quant != 0, D, queries_per_tile, resident != 0, masked != 0);
}

// The scan kernel's query tile for (k, quant, D, masked): 2 * queries +
// resident, or 0 if no tile fits.
int topk_mips_scan_tile(int k, int quant, int D, int masked) {
  bool resident = false;
  const int qw = scan_width(k, quant != 0, D, masked != 0, &resident);
  return qw == 0 ? 0 : 2 * 8 * qw + (resident ? 1 : 0);
}

// The int32 scratch (`part_r`) a call of topk_mips_launch needs: the chunk
// lists' rows (Q * n_chunks * k), the score floors (Q) and, masked, each
// query tile's compacted list (n_valid), its row blocks' counts and its
// length.  0 if no query tile fits.
size_t topk_mips_scratch_ints(int Q, int D, int n_valid, int k, int masked, int quant,
                              int n_chunks) {
  bool resident = false;
  const int qw = scan_width(k, quant != 0, D, masked != 0, &resident);
  if (qw == 0) return 0;
  const size_t q_tiles = (size_t)(Q + 8 * qw - 1) / (8 * qw);
  const size_t compact =
      masked ? q_tiles * ((size_t)n_valid + compact_blocks(n_valid) + 1) : 0;
  return (size_t)Q * n_chunks * k + Q + compact;
}

// Resident pass-1 CTAs per SM of the kernel a call with these arguments
// launches (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *ctas.
// Returns the CUDA error code.
int topk_mips_occupancy(int masked, int quant, int k, int D, int* ctas) {
  bool resident = false;
  const int qw = scan_width(k, quant != 0, D, masked != 0, &resident);
  if (qw == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = raise_scan_ceilings()) != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, scan_kernel(masked != 0, quant != 0, qw), kThreads,
      scan_smem_bytes(k, quant != 0, D, 8 * qw, resident, masked != 0));
}

// Launch every pass on `stream`, with no read back to the host.  `bank` is
// f32 (quant == 0) or int8 codes with per-row `scales` (quant != 0);
// `q_ns`/`bank_ns` are read only when masked != 0.  part_s holds Q *
// n_chunks * k entries, part_r topk_mips_scratch_ints(...).  The scan
// kernel splits its entries' 256-row tiles evenly over n_chunks (at most
// one chunk a tile of the live prefix).  Returns the CUDA error code of the
// launches (0 on success).
int topk_mips_launch(const float* q, const void* bank, const float* scales,
                     const int* q_ns, const int* bank_ns, int Q, int D,
                     int n_valid, int k, int masked, int quant, int n_chunks,
                     float* part_s, int* part_r, float* out_s, int* out_i, void* stream) {
  const int n_tiles = (n_valid + kTileRows - 1) / kTileRows;
  if (Q < 0 || D < 0 || n_valid < 0 || k < 1 || k > kScanMaxK || n_chunks < 0 ||
      n_chunks > n_tiles || (n_chunks > 0 && masked && (q_ns == nullptr || bank_ns == nullptr)) ||
      (n_chunks > 0 && quant && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = raise_scan_ceilings()) != cudaSuccess) return (int)err;
  if (n_chunks > 0) {
    bool resident = false;
    const int qw = scan_width(k, quant != 0, D, masked != 0, &resident);
    if (qw == 0) return (int)cudaErrorInvalidValue;
    const int qt = 8 * qw;
    const dim3 grid(n_chunks, (Q + qt - 1) / qt);
    const size_t smem = scan_smem_bytes(k, quant != 0, D, qt, resident, masked != 0);
    const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
    const uintptr_t ba = reinterpret_cast<uintptr_t>(bank);
    bool vec = quant ? (D % 16 == 0 && ba % 16 == 0) : (D % 4 == 0 && ba % 16 == 0);
    bool qvec = D % 4 == 0 && qa % 16 == 0;
    unsigned* floor_key = reinterpret_cast<unsigned*>(part_r + (size_t)Q * n_chunks * k);
    int* list = nullptr;
    int* list_len = nullptr;
    int list_stride = n_valid;
    if (masked) {
      list = reinterpret_cast<int*>(floor_key + Q);
      int* counts = list + (size_t)grid.y * list_stride;
      const dim3 cgrid(compact_blocks(n_valid), grid.y);
      list_len = counts + (size_t)grid.y * cgrid.x;
      topk_count_kernel<<<cgrid, kThreads, 0, st>>>(q_ns, bank_ns, Q, n_valid, qt, counts);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      topk_compact_kernel<<<cgrid, kThreads, 0, st>>>(q_ns, bank_ns, Q, n_valid, qt, counts,
                                                      list, list_stride, list_len);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    if ((err = cudaMemsetAsync(floor_key, 0, sizeof(unsigned) * Q, st)) != cudaSuccess)
      return (int)err;
    const void* scan = scan_kernel(masked != 0, quant != 0, qw);
    // A sample pass when chunks may be long (n_tiles bounds a masked
    // call's list; its CTAs check the list's own length): the last tile of
    // each chunk, one a CTA, merged exactly; their k-th score becomes each
    // query's floor.
    bool sample = n_tiles >= kSampleRatio * n_chunks;
    void* args[] = {(void*)&q,        (void*)&bank,     (void*)&scales,  (void*)&q_ns,
                    (void*)&bank_ns,  (void*)&list,     (void*)&list_len, (void*)&list_stride,
                    (void*)&Q,        (void*)&D,        (void*)&n_valid, (void*)&k,
                    (void*)&n_chunks, (void*)&resident, (void*)&vec,     (void*)&qvec,
                    (void*)&part_s,   (void*)&part_r,   (void*)&floor_key, (void*)&sample};
    if (sample) {
      if ((err = cudaLaunchKernel(scan, grid, dim3(kThreads), args, smem, st)) != cudaSuccess)
        return (int)err;
      topk_merge_lists_kernel<<<Q, kThreads, merge_lists_smem_bytes(k), st>>>(
          part_s, part_r, k, n_chunks, out_s, out_i, floor_key, list_len, qt);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    sample = false;
    if ((err = cudaLaunchKernel(scan, grid, dim3(kThreads), args, smem, st)) != cudaSuccess)
      return (int)err;
  }
  topk_merge_lists_kernel<<<Q, kThreads, merge_lists_smem_bytes(k), st>>>(
      part_s, part_r, k, n_chunks, out_s, out_i, nullptr, nullptr, 1);
  return (int)cudaGetLastError();
}

// The large-k path's workspace (bytes) for chunks of `qc` queries of
// width D on a card of `sms` SMs.
size_t topk_mips_large_workspace_bytes(int qc, int n_valid, int k, int masked, int D, int sms) {
  return carve_large(nullptr, qc, n_valid, k, masked != 0, D, sms).bytes;
}

// The large-k path's tile plan of qc (<= 1024) query labels alone, on
// `stream`: slot_query and slot_ns hold group_tiles_max(qc) * 32
// ints, n_tiles one.  Returns the CUDA error code.
int topk_mips_large_plan(const int* q_ns, int qc, int* slot_query, int* slot_ns, int* n_tiles,
                         void* stream) {
  if (qc < 1 || qc > kPlanMax || q_ns == nullptr) return (int)cudaErrorInvalidValue;
  topk_group_plan_kernel<<<1, kPlanMax, 0, static_cast<cudaStream_t>(stream)>>>(
      q_ns, qc, group_tiles_max(qc), slot_query, slot_ns, n_tiles);
  return (int)cudaGetLastError();
}

// Launch the large-k path (k > kScanMaxK) on `stream`, chunk by chunk of
// `qc` queries (at most 1024 masked) through one workspace of
// topk_mips_large_workspace_bytes(qc, ...) bytes, with no read back to the
// host.  Operands as topk_mips_launch; out_s/out_i hold Q * k entries.
// Returns the CUDA error code (0 on success).
int topk_mips_large_launch(const float* q, const void* bank, const float* scales,
                           const int* q_ns, const int* bank_ns, int Q, int D, int n_valid,
                           int k, int masked, int quant, int qc, int sms, void* workspace,
                           float* out_s, int* out_i, void* stream) {
  if (Q < 0 || D < 0 || n_valid < 0 || k <= kScanMaxK || qc < 1 || sms < 1 ||
      workspace == nullptr || (masked && (q_ns == nullptr || bank_ns == nullptr || qc > kPlanMax)) ||
      (quant && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  cudaError_t err;
  if ((err = raise_large_ceilings()) != cudaSuccess) return (int)err;
  const LargeWorkspace w = carve_large(workspace, qc, n_valid, k, masked != 0, D, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int c0 = 0; c0 < Q; c0 += qc) {
    if ((err = large_chunk(q + (size_t)c0 * D, bank, scales, masked ? q_ns + c0 : nullptr,
                           bank_ns, min(qc, Q - c0), D, n_valid, k, masked != 0, quant != 0, w,
                           sms, out_s + (size_t)c0 * k, out_i + (size_t)c0 * k, st)) !=
        cudaSuccess)
      return (int)err;
  }
  return 0;
}

}  // extern "C"
