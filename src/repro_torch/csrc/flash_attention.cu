// Blocked GQA attention for Hopper (prefill and the bidirectional encoder):
// the Pallas TPU kernel src/repro/kernels/flash_attention.py `_kernel`
// (pallas_call :93), forward only.
//
// q (B, K, G, S, D), k and v (B, K, T, D), f32 or bf16, any strides with a
// unit stride on D (the model's (B, S, H, D) projections and the (B, T, K, D)
// cache are read in place, no transposed copy).  For query position s and
// key t of the same (b, kv-head): score = (q . k) * scale, allowed where
// t < T, and t <= s (or t < prefix_len, the prefix-LM mask of an image
// prefix) when causal, and t > s - window when window > 0, comparing
// absolute positions: s and t plus row b's query and key offsets when
// the call gives them (a window of positions past 0), where a key below
// position 0 is masked too, as the reference's `_allowed`.  Output
// = softmax over the allowed keys . v, finalised as acc / max(l, 1e-37), in
// q's dtype (0 for a query with no allowed key).
//
// Two families of instances, chosen by dtype:
//   * f32 (`flash_fwd_kernel`, below): plain FP32 on the CUDA cores, no TF32
//     and no tensor cores: the reference holds an f32 call to 2e-5, and
//     memori-agent and its train step are f32 models;
//   * bf16 (`flash_fwd_tc_kernel`, the section "bf16 on the tensor cores"):
//     both products on the tensor cores (mma.sync m16n8k16, bf16 x bf16 ->
//     f32, FlashAttention-2's layout).  bf16 x bf16 products are exact in
//     f32, so S differs from an FP32 sum only in its order; the one new
//     rounding is P to bf16 before P.V (2^-9 relative a weight), while the
//     softmax sum l adds the unrounded f32 p, as FlashAttention-2 does.  The
//     zoo holds a bf16 call to 2e-2 x max|v| of its plain version.
//
// What bounds the f32 kernel: operations.  Causal prefill of S tokens does
// 2 * 2 * K * G * D * S(S+1)/2 flops against (2 K T + 2 K G S) * D * 4 bytes:
// at the long-context shape (K=4, G=3, S=T=4096, D=64) 25.8 GFLOP, 0.39 ms
// at 67 TFLOP/s of non-tensor-core FP32, against 25 MB (7.5 us) of memory.
// At the agent's prefill (S ~ 150) the work is a few microseconds, and what
// costs is filling 132 SMs and the latency of each CTA's few tiles.
//
// Design (not the TPU grid: Pallas walks the kv axis in order inside one
// core, keeping m, l and acc in VMEM scratch between grid steps):
//   * query rows are the (s, g) pairs of a kv-head flattened s-major, so a
//     CTA's block of rows holds consecutive positions of all G grouped heads
//     and every K/V tile staged in shared memory serves all G heads;
//   * two CTA shapes (`Shape`, mirrored by the wrapper's `flash_grid`),
//     chosen by the launcher from the grid and the SM count: the wide one, 128
//     threads each owning 4 rows x 4 keys of a 64 x 32 score tile at D <= 64
//     (128 registers, 61 KB of shared memory: three CTAs, 12 warps an SM),
//     for problems that fill the card with it; the narrow one, 64 threads
//     over 8 rows, when the wide grid would leave SMs idle (the agent's
//     prefill: 32 wide CTAs, 228 narrow ones).  8 rows x 8 keys a thread
//     reads shared memory half as often per FMA but takes 255 registers and
//     one 4-warp CTA an SM, and measured slower at S = T = 4096 (PERF.md);
//   * a 1-D grid ordered by row block, the heaviest causal blocks first, so
//     the long diagonal CTAs start before the short ones (a block's keys,
//     max(s_hi + 1, prefix_len), never fall with the block index, so the
//     order holds with a prefix too);
//   * K/V tiles double-buffered by 16-byte cp.async (plain loads when a row
//     is not 16-byte aligned): the next tile's copy is issued right after
//     the barrier that frees its buffer and overlaps this tile's products;
//   * scores: per 4-deep step a thread reads its keys' K rows and its rows'
//     queries as float4 (rows padded by 16 bytes: no bank conflicts; the 8
//     threads of a row group broadcast the query) — RT x KC x 4 FMAs for
//     RT + KC vector reads; the running max and sum stay in registers, reduced over
//     the row's 8 threads by shuffles; masked scores get exactly zero weight;
//   * P goes to shared memory key-major and P.V reads each thread's rows of
//     P and its float4 columns of V, the accumulator in registers.  With a
//     window the key loop starts at the first tile any row can see; causal,
//     it stops at the block's last position or the prefix's end, whichever
//     is later.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "attention_common.cuh"

namespace {

constexpr int kKeyGroups = 8;  // threads sharing a row (lanes differing in bits 0-2)

struct Strides {  // element strides; D has stride 1
  long long q[4];  // b, k, g, s
  long long k[3];  // b, k, t
  long long v[3];  // b, k, t
  long long o[4];  // b, k, g, s
};

__device__ __forceinline__ void fma4(float4& acc, float p, float4 v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

// A CTA shape: RT rows x KC keys per thread, RG row groups of kKeyGroups
// threads; the CTA covers RG * RT query rows against tiles of 8 * KC keys.
template <typename T, int DP, int RT, int RG, int KC>
struct Cfg {
  static constexpr int kThreads = RG * kKeyGroups;
  static constexpr int kRows = RG * RT;
  static constexpr int kKeys = kKeyGroups * KC;
  static constexpr int kQS = DP + 4;                    // query row (floats)
  static constexpr int kRS = DP + 16 / (int)sizeof(T);  // K/V row (elements)
  static constexpr int kPS = kRows + 4;                 // P row: one key (floats)
  static constexpr int kCols = DP / (4 * kKeyGroups);   // float4 columns per thread
  static constexpr size_t kSmem = sizeof(float) * ((size_t)kRows * kQS + (size_t)kKeys * kPS) +
                                  sizeof(T) * 4 * (size_t)kKeys * kRS;  // 2 stages of K and V
};

template <typename T, int DP, int RT, int RG, int KC, bool kOff>
__global__ void __launch_bounds__(RG * kKeyGroups, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int K, int B, int G,
                 int S, int T_len, int D, float scale, int causal, int window,
                 int prefix_len, const int* __restrict__ prefix_rows,
                 const int* __restrict__ pos_off, int vec, Strides st) {
  using C = Cfg<T, DP, RT, RG, KC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Pt = Qs + C::kRows * C::kQS;
  T* ring = reinterpret_cast<T*>(Pt + C::kKeys * C::kPS);

  const int tid = threadIdx.x;
  const int tx = tid % kKeyGroups, ty = tid / kKeyGroups;
  const int R = G * S;
  const int n_blocks = (R + C::kRows - 1) / C::kRows;
  const int per_block = K * B;
  const int ord = blockIdx.x / per_block, rem = blockIdx.x % per_block;
  const int kh = rem % K, b = rem / K;
  const int rb = causal ? n_blocks - 1 - ord : ord;  // heaviest causal block first
  const int r0 = rb * C::kRows;
  const T* qb = q + b * st.q[0] + kh * st.q[1];
  const T* kb = k + b * st.k[0] + kh * st.k[1];
  const T* vb = v + b * st.v[0] + kh * st.v[1];

  for (int i = tid; i < C::kRows * DP; i += C::kThreads) {
    const int r = i / DP, d = i % DP, rr = r0 + r;
    float x = 0.f;
    if (rr < R && d < D) x = to_f32(qb[(rr % G) * st.q[2] + (rr / G) * st.q[3] + d]);
    Qs[r * C::kQS + d] = x;
  }
  if (D < DP) {  // the ring's columns past D are never copied: zero them once
    for (int i = tid; i < 4 * C::kKeys * (DP - D); i += C::kThreads)
      store(ring + (size_t)(i / (DP - D)) * C::kRS + D + i % (DP - D), 0.f);
  }

  const int s_lo = r0 / G;
  const int s_hi = (min(r0 + C::kRows, R) - 1) / G;
  // offset positions: query s sits at s + dq in the keys' frame, and key t
  // at absolute position t - t_lo (masked below 0)
  const int t_lo = kOff ? -pos_off[B + b] : 0;
  const int dq = kOff ? pos_off[b] + t_lo : 0;
  // the prefix: keys t < P are visible to every row (causal only)
  const int P = (prefix_rows != nullptr ? prefix_rows[b] : prefix_len) + t_lo;
  const int t_end = causal ? min(T_len, max(s_hi + dq + 1, P)) : T_len;
  int t_begin = window > 0 ? max(0, s_lo + dq - window + 1) : 0;
  t_begin -= t_begin % C::kKeys;

  auto stage = [&](int t0) {
    T* Ks = ring + (size_t)((t0 / C::kKeys) & 1) * 2 * C::kKeys * C::kRS;
    stage_tile<T, C::kRS, C::kThreads>(Ks, Ks + C::kKeys * C::kRS, kb, vb, st.k[2], st.v[2],
                                       t0, min(C::kKeys, T_len - t0), D, vec, tid);
  };

  float m[RT], l[RT];
  float4 acc[RT][C::kCols];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  if (t_begin < t_end) stage(t_begin);
  for (int t0 = t_begin; t0 < t_end; t0 += C::kKeys) {
    cp_async_wait<0>();
    __syncthreads();  // tile t0 visible; the previous tile's buffer and P are free
    if (t0 + C::kKeys < t_end) stage(t0 + C::kKeys);
    const T* Ks = ring + (size_t)((t0 / C::kKeys) & 1) * 2 * C::kKeys * C::kRS;
    const T* Vs = Ks + C::kKeys * C::kRS;

    float sc[RT][KC];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < KC; ++c) sc[i][c] = 0.f;
#pragma unroll 1
    for (int d = 0; d < DP; d += 4) {  // zero padding past D adds exact zeros
      float4 kv[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) kv[c] = load4(Ks + (tx + kKeyGroups * c) * C::kRS + d);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (ty * RT + i) * C::kQS + d);
#pragma unroll
        for (int c = 0; c < KC; ++c) sc[i][c] = dot4(qv, kv[c], sc[i][c]);
      }
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int rr = r0 + ty * RT + i;
      const int s = rr < R ? rr / G : -1;  // the row's query position, -1 past the end
      bool ok[KC];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int t = t0 + tx + kKeyGroups * c;
        ok[c] = s >= 0 && t < T_len && (!kOff || t >= t_lo) &&
                (!causal || t <= s + dq || t < P) &&
                (window <= 0 || t > s + dq - window);
        sc[i][c] *= scale;
        if (ok[c]) mx = fmaxf(mx, sc[i][c]);
      }
#pragma unroll
      for (int off = 1; off < kKeyGroups; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const float p = ok[c] ? expf(sc[i][c] - m_new) : 0.f;
        sum += p;
        Pt[(tx + kKeyGroups * c) * C::kPS + ty * RT + i] = p;
      }
#pragma unroll
      for (int off = 1; off < kKeyGroups; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) {
        acc[i][c].x *= corr;
        acc[i][c].y *= corr;
        acc[i][c].z *= corr;
        acc[i][c].w *= corr;
      }
    }
    __syncthreads();  // P visible

    const int n_keys = min(C::kKeys, T_len - t0);  // rows past T are never read
    for (int j = 0; j < n_keys; ++j) {
      float p[RT];
      const float* pj = Pt + j * C::kPS + ty * RT;
      if constexpr (RT % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RT; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(pj + i);
          p[i] = x.x;
          p[i + 1] = x.y;
          p[i + 2] = x.z;
          p[i + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < RT; ++i) p[i] = pj[i];
      }
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) {
        const float4 vx = load4(Vs + j * C::kRS + 4 * (tx + kKeyGroups * c));
#pragma unroll
        for (int i = 0; i < RT; ++i) fma4(acc[i][c], p[i], vx);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int rr = r0 + ty * RT + i;
    if (rr >= R) continue;
    T* ob = out + b * st.o[0] + kh * st.o[1] + (rr % G) * st.o[2] + (rr / G) * st.o[3];
    const float inv = 1.f / fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) {
      const int d0 = 4 * (tx + kKeyGroups * c);
      const float a[4] = {acc[i][c].x, acc[i][c].y, acc[i][c].z, acc[i][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < D) store(ob + d0 + e, a[e] * inv);
    }
  }
}

// -- bf16 on the tensor cores --------------------------------------------------
//
// What bounds it: at the zoo's shapes the bytes a CTA fetches and the
// latency of its few tiles, not the tensor cores (MLA's prefill is 2
// GFLOP, 2 us at 989 TFLOP/s).  A CTA of 4 warps covers 64 flattened
// (s, g) rows of one (b, kv-head), warp w rows [16 w, 16 w + 16), so each
// K/V tile staged in shared memory serves all G heads of those positions.
// Per BN-key tile a warp computes S = Q K^T for its 16 rows by m16n8k16
// mma (Q and K fragments by ldmatrix, D rounded up to 16 deep: D = 192
// runs 192 deep), runs the online softmax on the accumulator fragments in
// registers (base-2 exponentials of scale * log2 e; masked scores at -inf,
// so exactly zero weight; the accumulator rescaled only when a row's
// maximum moved), rounds P to bf16 and feeds it from registers as the A
// operand of O += P V (V by ldmatrix.trans).
//   * K/V tiles come by tensor-map copies (TMA): 64-column boxes of BN
//     rows, 128-byte swizzled (the ldmatrix addresses undo the swizzle),
//     one thread issuing them, each of NS stages counted on an mbarrier;
//     rows past T and columns past D land as zeros.  With 16-byte cp.async
//     from every thread, issuing the next tile's copies took longer than
//     the tile's products on the H100 (PERF.md); rows that are not
//     16-byte aligned (D = 50, 515) are stored by plain loads into the same
//     layout.  The Q block comes once by cp.async.
//   * Two CTA shapes: wide, one CTA walks all of its row block's keys;
//     narrow, when the wide grid would leave SMs idle, a cluster of 2, 4
//     or 8 CTAs on gridDim.z splits the block's key tiles and combines
//     their (m, l, acc) through distributed shared memory, rank r
//     finalising rows [r 64 / n, (r + 1) 64 / n) of the block (whisper's
//     cross-attention: 24 row blocks over 1,500 keys, 8-way split).
//   * Columns [c0, c0 + DV) of the output: D <= 256 is one slice (DV =
//     DK); MLA's 576-wide latent takes ceil(D / 192) slices on gridDim.y,
//     each recomputing S (a 16 x 576 f32 accumulator would be 288 registers
//     a lane).
template <int DK, int DV, bool kNarrow, int BN, int NS>
struct TcCfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kNT = BN / 8;  // a warp's key n-tiles of a tile
  static constexpr int kQS = DK + 8;  // Q row in shared memory (elements): 16-byte
                                      // aligned, and 8 rows hit 32 distinct banks
  static constexpr int kAS = DV + 4;  // narrow: a row of the f32 accumulator, combining
  // a K / V tile: 64-column chunks of BN 128-byte rows, 128-byte swizzled
  // (16-byte unit u of row r at u ^ (r % 8)), as the tensor-map copies lay
  // them down; 1024-byte aligned
  static constexpr int kKC = DK / 64, kVC = DV / 64;
  static constexpr int kChunk = BN * 64;  // elements
  static constexpr int kStage = (kKC + kVC) * kChunk;
  static constexpr int kRing = ((kRows * kQS * 2 + 1023) / 1024) * 1024;  // bytes before it
  static constexpr size_t kSmem = 1024 + kRing + NS * (size_t)kStage * 2;  // + alignment
  static_assert(!kNarrow || (size_t)kRows * kAS * 4 + 1024 <= kSmem, "the combine fits");
};

template <int DK, int DV, bool kNarrow, int BN, int NS, bool kOff>
__global__ void __launch_bounds__(TcCfg<DK, DV, kNarrow, BN, NS>::kThreads, 1)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int K,
                    int B, int G, int S, int T_len, int D, float scale, int causal, int window,
                    int prefix_len, const int* __restrict__ prefix_rows,
                    const int* __restrict__ pos_off, int vec, int qvec,
                    Strides st, const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv) {
  using C = TcCfg<DK, DV, kNarrow, BN, NS>;
  using bf16 = __nv_bfloat16;
  constexpr int NT = C::kNT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + C::kRing);  // NS stages: K chunks, V chunks
  __shared__ float cm[kNarrow ? C::kRows : 1], cl[kNarrow ? C::kRows : 1];  // narrow: m, l
  __shared__ __align__(8) uint64_t full_bar[NS];  // a stage's tile has landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = G * S;
  const int n_blocks = (R + C::kRows - 1) / C::kRows;
  const int per_block = K * B;
  const int ord = blockIdx.x / per_block, rem = blockIdx.x % per_block;
  const int kh = rem % K, b = rem / K;
  const int rb = causal ? n_blocks - 1 - ord : ord;  // heaviest causal block first
  const int r0 = rb * C::kRows;
  const int c0 = blockIdx.y * DV;             // this CTA's output columns
  const int nv = min(DV, D - c0);
  const int DQ = (D + 15) & ~15;              // the products' depth
  const bf16* qb = q + b * st.q[0] + kh * st.q[1];
  const bf16* kb = k + b * st.k[0] + kh * st.k[1];
  const bf16* vb = v + b * st.v[0] + kh * st.v[1] + c0;

  // Q rows (zero past R and past D), by cp.async when 16-byte aligned
  for (int row = tid / kCopyTPR; row < C::kRows; row += C::kThreads / kCopyTPR) {
    const int rr = r0 + row;
    bf16* d = Qs + row * C::kQS;
    const bf16* s = qb + (rr % G) * st.q[2] + (long long)(rr / G) * st.q[3];
    if (qvec) {
      for (int c = 8 * (tid % kCopyTPR); c < DQ; c += 8 * kCopyTPR) {
        if (rr < R && c < D) cp_async16(d + c, s + c);
        else *reinterpret_cast<uint4*>(d + c) = make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int c = tid % kCopyTPR; c < DQ; c += kCopyTPR)
        d[c] = rr < R && c < D ? s[c] : __float2bfloat16_rn(0.f);
    }
  }
  if (!vec) {  // plain loads never write K's columns past D: zero the ring once
    for (int i = tid; i < NS * C::kStage / 8; i += C::kThreads)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();  // the Q rows' group
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(&full_bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int s_lo = r0 / G;
  const int s_hi = (min(r0 + C::kRows, R) - 1) / G;
  const int t_lo = kOff ? -pos_off[B + b] : 0;  // as the f32 kernel
  const int dq = kOff ? pos_off[b] + t_lo : 0;
  const int P = (prefix_rows != nullptr ? prefix_rows[b] : prefix_len) + t_lo;
  int t_end = causal ? min(T_len, max(s_hi + dq + 1, P)) : T_len;
  int t_begin = window > 0 ? max(0, s_lo + dq - window + 1) : 0;
  t_begin -= t_begin % BN;
  if constexpr (kNarrow) {  // this cluster rank's share of the block's key tiles
    const int tiles = t_end > t_begin ? (t_end - t_begin + BN - 1) / BN : 0;
    const int split = blockIdx.z, n_split = gridDim.z;
    const int lo = tiles * split / n_split, hi = tiles * (split + 1) / n_split;
    t_end = min(t_end, t_begin + hi * BN);
    t_begin += lo * BN;
  }

  // K rows [t0, t0 + BN) and V's columns [c0, c0 + nv) of them into stage
  // ((t0 - t_begin) / BN) % NS, swizzled.  With `vec` by the tensor map:
  // one box of 64 columns x BN rows a chunk, issued by thread 0 and counted
  // on the stage's barrier; rows past T and columns past D land as zeros
  // (p = 0 there, and 0 * NaN is not 0).  Else by plain loads (the zeros
  // stored), visible through the loop's __syncthreads, with one plain
  // arrival.  Past t_end: nothing
  const int kc = (D + 63) / 64, vc = (nv + 63) / 64;
  auto stage = [&](int t0) {
    if (t0 >= t_end) return;
    const int slot = (t0 - t_begin) / BN % NS;
    bf16* Ks = ring + (size_t)slot * C::kStage;
    bf16* Vs = Ks + C::kKC * C::kChunk;
    if (vec) {
      if (tid == 0) {
        mbar_expect(&full_bar[slot], 2u * C::kChunk * (kc + vc));
        for (int j = 0; j < kc; ++j) tma_load_4d(Ks + j * C::kChunk, &tmk, 64 * j, t0, kh, b,
                                                 &full_bar[slot]);
        for (int j = 0; j < vc; ++j) tma_load_4d(Vs + j * C::kChunk, &tmv, c0 + 64 * j, t0, kh,
                                                 b, &full_bar[slot]);
      }
    } else {
      const int n = min(BN, T_len - t0);
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int row = tid / kCopyTPR; row < BN; row += C::kThreads / kCopyTPR) {
        const bf16* kr = kb + (long long)(t0 + row) * st.k[2];
        const bf16* vr = vb + (long long)(t0 + row) * st.v[2];
        for (int col = tid % kCopyTPR; col < D; col += kCopyTPR) {
          const int at = (col >> 6) * C::kChunk + row * 64 +
                         ((((col & 63) >> 3) ^ (row & 7)) << 3) + (col & 7);
          Ks[at] = row < n ? kr[col] : zero;
          if (col < nv) Vs[at] = row < n ? vr[col] : zero;
        }
      }
      if (tid == 0) mbar_arrive(&full_bar[slot]);
    }
  };

  // this lane's two rows (g = lane / 4 and g + 8 of the warp's 16), and the
  // warp's positions and keys
  const int g4 = lane >> 2, t4 = lane & 3;
  const int wr0 = r0 + 16 * warp;
  int srow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = wr0 + g4 + 8 * i;
    srow[i] = rr < R ? rr / G : -1;
  }
  const bool w_live = wr0 < R;
  const bool w_full = wr0 + 16 <= R;
  const int ws_lo = wr0 / G, ws_hi = (min(wr0 + 16, R) - 1) / G;
  const int wt_end = causal ? min(T_len, max(ws_hi + dq + 1, P)) : T_len;
  const int wt_begin = window > 0 ? max(0, ws_lo + dq - window + 1) : 0;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int nv16 = (nv + 15) / 16;
  const bf16* qfrag = Qs + (16 * warp + (lane & 15)) * C::kQS + 8 * (lane >> 4);

  // NS - 1 tiles in flight: tile t0 + (NS - 1) BN is issued into the stage
  // the barrier has just freed while tile t0 computes
#pragma unroll 1
  for (int i = 0; i < NS - 1; ++i) stage(t_begin + i * BN);
  cp_async_wait<0>();  // the Q rows
  for (int t0 = t_begin; t0 < t_end; t0 += BN) {
    const int it = (t0 - t_begin) / BN;
    mbar_wait(&full_bar[it % NS], (it / NS) & 1);
    __syncthreads();  // tile t0 (and Q) visible; the stage of t0 - BN is free
    stage(t0 + (NS - 1) * BN);
    if (!w_live || t0 >= wt_end || t0 + BN <= wt_begin) continue;  // warp-uniform
    const bf16* Ks = ring + (size_t)(it % NS) * C::kStage;
    const bf16* Vs = Ks + C::kKC * C::kChunk;

    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    // lane l reads key row l % 8 (+ 8 for l >= 16) of a key pair, 16-byte
    // unit (l / 8) % 2 of the k-step, at its swizzled place
    const bf16* kfrag = Ks + ((lane & 7) + 8 * (lane >> 4)) * 64;
    const int kx = lane & 7, ku = (lane >> 3) & 1;
    auto qk_step = [&](int kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qfrag + kk);
      const bf16* kf0 = kfrag + (kk >> 6) * C::kChunk + (((((kk & 63) >> 3) + ku) ^ kx) << 3);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kf0 + 8 * j * 64);
        mma_bf16(sc[j], a, kf[0], kf[1]);
        mma_bf16(sc[j + 1], a, kf[2], kf[3]);
      }
    };
    if (DQ == DK) {  // the class's full depth: one straight run the compiler can schedule
#pragma unroll
      for (int kk = 0; kk < DK; kk += 16) qk_step(kk);
    } else {
#pragma unroll 2
      for (int kk = 0; kk < DQ; kk += 16) qk_step(kk);
    }

    // scores in log2 units; where not every key of the tile is allowed for
    // every row of the warp, masked ones to -inf
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] *= sl2;
    const bool full = w_full && t0 + BN <= T_len && (!kOff || t0 >= t_lo) &&
                      (!causal || t0 + BN - 1 <= ws_lo + dq || t0 + BN <= P) &&
                      (window <= 0 || t0 > ws_hi + dq - window);
    if (!full) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = srow[i];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = t0 + 8 * j + 2 * t4 + e;
            if (!(s >= 0 && t < T_len && (!kOff || t >= t_lo) &&
                  (!causal || t <= s + dq || t < P) &&
                  (window <= 0 || t > s + dq - window)))
              sc[j][2 * i + e] = -INFINITY;
          }
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * i], sc[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);  // m starts finite (kNegInf): never inf - inf
      corr[i] = fast_exp2(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(sc[j][2 * i + e] - m_new);  // masked: exactly 0
          sc[j][2 * i + e] = p;
          sum += p;  // l sums the f32 p, before P is rounded to bf16
        }
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {  // a row's max moved
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
    }

    // lane l reads key row l % 8 (+ 8 for (l / 8) odd) of a 16-key step,
    // column unit l / 16 of a column pair, at its swizzled place
    const bf16* vfrag = Vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * 64;
    const int vu = lane >> 4;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      auto pv_step = [&](int j) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vfrag + 16 * kk * 64 + (j >> 2) * C::kChunk +
                                  ((((2 * j) & 7) + vu) ^ kx) * 8);
        mma_bf16(acc[2 * j], a, vf[0], vf[1]);
        mma_bf16(acc[2 * j + 1], a, vf[2], vf[3]);
      };
      if (nv16 == DV / 16) {  // every column of the slice: no per-pair branch
#pragma unroll
        for (int j = 0; j < DV / 16; ++j) pv_step(j);
      } else {
#pragma unroll
        for (int j = 0; j < DV / 16; ++j)
          if (j < nv16) pv_step(j);
      }
    }
  }
  cp_async_wait<0>();  // no copy in flight past here (a CTA with no key)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if constexpr (kNarrow) {
    // every rank's (m, l) and accumulator rows into its own shared memory
    // (the ring, now free), then rank r combines its rows from all ranks:
    // weights 2^(m - M), 0 for a rank with no allowed key of the row
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* wacc = reinterpret_cast<float*>(smem);
    __syncthreads();  // every warp is done with Q and the ring
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (t4 == 0) {
        cm[16 * warp + g4 + 8 * i] = m[i];
        cl[16 * warp + g4 + 8 * i] = l[i];
      }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(wacc + (16 * warp + g4 + 8 * i) * C::kAS + 8 * j + 2 * t4) =
            make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    cluster.sync();
    const int n_split = gridDim.z, rank = (int)cluster.block_rank();
    const int rows = C::kRows / n_split;    // this rank's rows: [r0 + row0, + rows)
    const int tpr = C::kThreads / rows;     // threads a row, 4 columns each in turn
    const int r = rank * rows + tid / tpr, rr = r0 + r;
    if (rr < R) {
      float w[8], M = kNegInf, L = 0.f;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        w[p] = 0.f;
        if (p < n_split && *cluster.map_shared_rank(&cl[r], p) > 0.f)
          M = fmaxf(M, *cluster.map_shared_rank(&cm[r], p));
      }
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if (p >= n_split) continue;
        const float lp = *cluster.map_shared_rank(&cl[r], p);
        w[p] = lp > 0.f ? fast_exp2(*cluster.map_shared_rank(&cm[r], p) - M) : 0.f;
        L = fmaf(lp, w[p], L);
      }
      const float inv = 1.f / fmaxf(L, 1e-37f);
      bf16* ob = out + b * st.o[0] + kh * st.o[1] + (rr % G) * st.o[2] +
                 (long long)(rr / G) * st.o[3] + c0;
      for (int d = 4 * (tid % tpr); d < nv; d += 4 * tpr) {
        float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          if (p >= n_split) continue;
          const float4 y =
              *reinterpret_cast<const float4*>(cluster.map_shared_rank(wacc + r * C::kAS + d, p));
          A.x = fmaf(y.x, w[p], A.x);
          A.y = fmaf(y.y, w[p], A.y);
          A.z = fmaf(y.z, w[p], A.z);
          A.w = fmaf(y.w, w[p], A.w);
        }
        const float a4[4] = {A.x, A.y, A.z, A.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < nv) ob[d + e] = __float2bfloat16_rn(a4[e] * inv);
      }
    }
    cluster.sync();  // no rank leaves while another reads its shared memory
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = wr0 + g4 + 8 * i;
      if (rr >= R) continue;
      bf16* ob = out + b * st.o[0] + kh * st.o[1] + (rr % G) * st.o[2] +
                 (long long)(rr / G) * st.o[3] + c0;
      const float inv = 1.f / fmaxf(l[i], 1e-37f);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int d = 8 * j + 2 * t4;
        if (d >= nv) continue;
        const float x0 = acc[j][2 * i] * inv, x1 = acc[j][2 * i + 1] * inv;
        if (d + 1 < nv && (D & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(ob + d) = __floats2bfloat162_rn(x0, x1);
        } else {
          ob[d] = __float2bfloat16_rn(x0);
          if (d + 1 < nv) ob[d + 1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

// The bf16 instances per head-dim class DK (D rounded up to 64, 128, 192,
// 256 or 576; kernels/flash_attention.py `TC_CONFIGS` mirrors rows and
// keys): 4 warps (64 rows), with two or three stages of K and V and the Q
// block in shared memory (64-row CTAs measured faster than 128-row ones at
// every zoo shape, PERF.md):
//   * DK 64 and 128: 64-key tiles;
//   * DK 192 and 256: 32-key tiles: a warp holds a 16 x DK f32 accumulator,
//     96 / 128 registers a lane, beside its scores;
//   * DK 576 (MLA's absorbed latent): 192 output columns a CTA (96
//     accumulator registers), 32-key tiles.
template <int DK, bool kNarrow>
struct TcShape {
  static constexpr int DV = DK > 256 ? 192 : DK;
  static constexpr int BN = DK <= 128 ? 64 : 32;
  static constexpr int NS = DK <= 128 ? 2 : DK <= 192 ? 3 : DK <= 256 ? 2 : 3;
};

// The two CTA shapes per padded head dim DP: RT rows per thread, RG row
// groups, KC keys per thread.  kernels/flash_attention.py `FLASH_CONFIGS`
// mirrors their rows per CTA and keys per tile.
//
// DP = 576 is MLA's absorbed width (the latent's 512 + the 64 rope columns;
// one kv head shared by G = 128 query heads at deepseek's width).  A thread
// then holds 18 float4 columns of its row's accumulator, so one row a
// thread; the K/V tiles are 16 keys (KC = 2): f32 shared memory is
// 4 (rows x 580 + 16 x (rows + 4)) + 4 x 4 x 16 x 580 bytes, 164 KB narrow
// (8 rows) and 183 KB wide (16 rows), under the 227 KB a block may opt
// into (KC = 4 would need 317 KB).  The rows of one (b, kv-head) number
// G * S (4.2 M at prefill_32k), so the grid stays far under 2^31 CTAs.
template <int DP, bool kNarrow>
struct Shape {
  static constexpr int RT = (kNarrow || DP > 256) ? 1 : (DP <= 64 ? 4 : 512 / DP);
  static constexpr int RG = kNarrow ? 8 : 16;
  static constexpr int KC = DP > 256 ? 2 : DP <= 64 ? (kNarrow ? 8 : 4) : DP <= 128 ? 8 : 4;
};

int sm_count(int device) {
  static int cached_device = -1, cached = 0;
  if (device != cached_device) {
    if (cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return 0;
    cached_device = device;
  }
  return cached;
}

template <typename T, int DP, bool kNarrow, bool kOff>
cudaError_t launch_shape(int device, const void* q, const void* k, const void* v, void* out,
                         int B, int K, int G, int S, int T_len, int D, float scale, int causal,
                         int window, int prefix_len, const int* prefix_rows, const int* pos_off, int vec,
                         const Strides& st, cudaStream_t stream, int* rows_per_cta) {
  using Sh = Shape<DP, kNarrow>;
  using C = Cfg<T, DP, Sh::RT, Sh::RG, Sh::KC>;
  static int attr_device = -1;  // the shared-memory ceiling is per device
  if (device != attr_device) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_fwd_kernel<T, DP, Sh::RT, Sh::RG, Sh::KC, kOff>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return err;
    attr_device = device;
  }
  const long long blocks = (long long)((G * S + C::kRows - 1) / C::kRows) * K * B;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, DP, Sh::RT, Sh::RG, Sh::KC, kOff><<<(unsigned)blocks, C::kThreads,
                                                         C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), K, B, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, pos_off,
      vec, st);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && rows_per_cta != nullptr) *rows_per_cta = C::kRows;
  return err;
}

// the wide shape when its grid puts at least one CTA on every SM, else the
// narrow one (kernels/flash_attention.py `flash_grid` is the same rule)
template <typename T, int DP>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* out, int B, int K,
                      int G, int S, int T_len, int D, float scale, int causal, int window,
                      int prefix_len, const int* prefix_rows, const int* pos_off, int vec, const Strides& st,
                      cudaStream_t s, int* rows_per_cta) {
  int device;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  constexpr int kWideRows = Shape<DP, false>::RT * Shape<DP, false>::RG;
  const long long wide = (long long)((G * S + kWideRows - 1) / kWideRows) * K * B;
  // a call without offsets runs the instances that take none
  auto shape = wide >= sm_count(device)
                   ? (pos_off ? launch_shape<T, DP, false, true> : launch_shape<T, DP, false, false>)
                   : (pos_off ? launch_shape<T, DP, true, true> : launch_shape<T, DP, true, false>);
  return shape(device, q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len,
               prefix_rows, pos_off, vec, st, s, rows_per_cta);
}

template <int DK, bool kNarrow, bool kOff>
cudaError_t launch_tc_shape(int device, const void* q, const void* k, const void* v, void* out,
                            int B, int K, int G, int S, int T_len, int D, float scale, int causal,
                            int window, int prefix_len, const int* prefix_rows, const int* pos_off, int vec,
                            const Strides& st, cudaStream_t stream, int n_split,
                            int* rows_per_cta) {
  using Sh = TcShape<DK, kNarrow>;
  using C = TcCfg<DK, Sh::DV, kNarrow, Sh::BN, Sh::NS>;
  auto kernel = flash_fwd_tc_kernel<DK, Sh::DV, kNarrow, Sh::BN, Sh::NS, kOff>;
  static int attr_device = -1;  // the shared-memory ceiling is per device
  if (device != attr_device) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return err;
    attr_device = device;
  }
  const long long blocks = (long long)((G * S + C::kRows - 1) / C::kRows) * K * B;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  // Q rows by 16-byte cp.async: D, the base and the b/k/g/s strides in 8-element units
  const int qvec = (reinterpret_cast<uintptr_t>(q) % 16 == 0) && D % 8 == 0 &&
                   st.q[0] % 8 == 0 && st.q[1] % 8 == 0 && st.q[2] % 8 == 0 &&
                   st.q[3] % 8 == 0;
  // K and V by the tensor-map copies when 16-byte aligned (`vec`) and
  // tensor maps describe them
  CUtensorMap tmk = {}, tmv = {};
  const int tma = vec && tile_map(&tmk, k, B, K, T_len, D, st.k, Sh::BN) &&
                  tile_map(&tmv, v, B, K, T_len, D, st.v, Sh::BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (D + Sh::DV - 1) / Sh::DV, n_split);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // narrow: the splits of a block
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_split;
  cfg.attrs = attr;
  cfg.numAttrs = kNarrow ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), K, B, G, S, T_len,
      D, scale, causal, window, prefix_len, prefix_rows, pos_off, tma, qvec, st, tmk, tmv);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && rows_per_cta != nullptr) *rows_per_cta = C::kRows / n_split;
  return err;
}

// the wide shape when its grid (row blocks x column slices) puts at least
// one CTA on every SM, else the narrow one, split the fewest ways of 2, 4
// and 8 that does (`flash_grid` for bf16)
template <int DK>
cudaError_t launch_tc_dk(const void* q, const void* k, const void* v, void* out, int B, int K,
                         int G, int S, int T_len, int D, float scale, int causal, int window,
                         int prefix_len, const int* prefix_rows, const int* pos_off, int vec, const Strides& st,
                         cudaStream_t s, int* rows_per_cta) {
  int device;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  using W = TcShape<DK, false>;
  constexpr int kRows = TcCfg<DK, W::DV, false, W::BN, W::NS>::kRows;
  const long long wide =
      (long long)((G * S + kRows - 1) / kRows) * K * B * ((D + W::DV - 1) / W::DV);
  const int sms = sm_count(device);
  // a call without offsets runs the instances that take none
  int n_split = 1;
  if (wide < sms) {
    n_split = 2;
    while (n_split < 8 && wide * n_split < sms) n_split *= 2;
  }
  auto shape = n_split == 1
                   ? (pos_off ? launch_tc_shape<DK, false, true> : launch_tc_shape<DK, false, false>)
                   : (pos_off ? launch_tc_shape<DK, true, true> : launch_tc_shape<DK, true, false>);
  return shape(device, q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len,
               prefix_rows, pos_off, vec, st, s, n_split, rows_per_cta);
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int B, int K, int G,
                      int S, int T_len, int D, float scale, int causal, int window,
                      int prefix_len, const int* prefix_rows, const int* pos_off, int vec, const Strides& st,
                      cudaStream_t s, int* rows_per_cta) {
  if (D <= 64) return launch_tc_dk<64>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, pos_off, vec, st, s, rows_per_cta);
  if (D <= 128) return launch_tc_dk<128>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, pos_off, vec, st, s, rows_per_cta);
  if (D <= 192) return launch_tc_dk<192>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, pos_off, vec, st, s, rows_per_cta);
  if (D <= 256) return launch_tc_dk<256>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, pos_off, vec, st, s, rows_per_cta);
  return launch_tc_dk<576>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, pos_off, vec, st, s, rows_per_cta);
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* out, int B, int K,
                         int G, int S, int T_len, int D, float scale, int causal, int window,
                         int prefix_len, const int* prefix_rows, const int* pos_off, int vec, const Strides& st,
                         cudaStream_t s, int* rows_per_cta) {
  if (D <= 32) return launch_dp<T, 32>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, pos_off, vec, st, s, rows_per_cta);
  if (D <= 64) return launch_dp<T, 64>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, pos_off, vec, st, s, rows_per_cta);
  if (D <= 128) return launch_dp<T, 128>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, pos_off, vec, st, s, rows_per_cta);
  if (D <= 256) return launch_dp<T, 256>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, pos_off, vec, st, s, rows_per_cta);
  return launch_dp<T, 576>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, pos_off, vec, st, s, rows_per_cta);
}

template <typename Kernel>
int occupancy_of(Kernel kernel, int threads, size_t smem, int* ctas_per_sm, int* smem_bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, threads, smem);
  *smem_bytes = (int)smem;
  return (int)err;
}

template <int DK, bool kNarrow>
int tc_occupancy_shape(int* ctas_per_sm, int* smem_bytes) {
  using Sh = TcShape<DK, kNarrow>;
  using C = TcCfg<DK, Sh::DV, kNarrow, Sh::BN, Sh::NS>;
  return occupancy_of(flash_fwd_tc_kernel<DK, Sh::DV, kNarrow, Sh::BN, Sh::NS, false>, C::kThreads,
                      C::kSmem, ctas_per_sm, smem_bytes);
}
template <int DK>
int tc_occupancy(int narrow, int* ctas_per_sm, int* smem_bytes) {
  return narrow ? tc_occupancy_shape<DK, true>(ctas_per_sm, smem_bytes)
                : tc_occupancy_shape<DK, false>(ctas_per_sm, smem_bytes);
}
template <int DP, bool kNarrow>
int f32_occupancy_shape(int* ctas_per_sm, int* smem_bytes) {
  using Sh = Shape<DP, kNarrow>;
  using C = Cfg<float, DP, Sh::RT, Sh::RG, Sh::KC>;
  return occupancy_of(flash_fwd_kernel<float, DP, Sh::RT, Sh::RG, Sh::KC, false>, C::kThreads,
                      C::kSmem, ctas_per_sm, smem_bytes);
}
template <int DP>
int f32_occupancy(int narrow, int* ctas_per_sm, int* smem_bytes) {
  return narrow ? f32_occupancy_shape<DP, true>(ctas_per_sm, smem_bytes)
                : f32_occupancy_shape<DP, false>(ctas_per_sm, smem_bytes);
}

}  // namespace

extern "C" {

// Largest head dimension the kernel takes.
int flash_attention_max_head_dim() { return 576; }

// Launch on `stream` (on the current device).  dtype 0 = f32, 1 = bf16 (q,
// k, v and out alike).  `strides` holds 14 element strides: q (b, k, g, s),
// k (b, k, t), v (b, k, t), out (b, k, g, s).  `vec` = 1 when k and v may be
// copied by 16-byte cp.async (D * element size, the b/k/t strides in bytes
// and both bases are 16-byte multiples).  With `causal`, keys t <
// prefix_rows[b] (a (B,) int32 array on the device) or, when that is null,
// t < prefix_len are visible to every query row (0: none).  `pos_off`,
// when not null, is a (2, B) int32 array on the device: row b's queries
// sit at absolute positions pos_off[b] + s and its keys at pos_off[B + b]
// + t, and the mask compares absolute positions (a key below position 0
// is masked; the prefix bounds the key's absolute position).  On a launch,
// writes the rows per CTA of the shape it launched to `rows_per_cta` unless
// that is null.  Returns the CUDA error code (0 on success).
int flash_attention_launch(int dtype, const void* q, const void* k, const void* v, void* out,
                           int B, int K, int G, int S, int T_len, int D, float scale,
                           int causal, int window, int prefix_len, const int* prefix_rows, const int* pos_off,
                           int vec, const long long* strides, void* stream,
                           int* rows_per_cta) {
  if (B < 0 || K < 0 || G < 0 || S < 0 || T_len < 1 || D < 1 || D > 576 ||
      window < 0 || prefix_len < 0 || strides == nullptr || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0 || G == 0 || S == 0) return 0;
  Strides st;
  for (int i = 0; i < 4; ++i) st.q[i] = strides[i];
  for (int i = 0; i < 3; ++i) st.k[i] = strides[4 + i];
  for (int i = 0; i < 3; ++i) st.v[i] = strides[7 + i];
  for (int i = 0; i < 4; ++i) st.o[i] = strides[10 + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_dtype<float>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window,
                                       prefix_len, prefix_rows, pos_off, vec, st, s, rows_per_cta)
                 : launch_tc(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window,
                             prefix_len, prefix_rows, pos_off, vec, st, s, rows_per_cta);
  return (int)err;
}

// Resident CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
// dynamic shared memory of the instance a launch of dtype and head dim D
// takes in the given CTA shape.  Returns the CUDA error code.
int flash_attention_occupancy(int dtype, int D, int narrow, int* ctas_per_sm, int* smem_bytes) {
  if (D < 1 || D > 576 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D <= 64) return tc_occupancy<64>(narrow, ctas_per_sm, smem_bytes);
    if (D <= 128) return tc_occupancy<128>(narrow, ctas_per_sm, smem_bytes);
    if (D <= 192) return tc_occupancy<192>(narrow, ctas_per_sm, smem_bytes);
    if (D <= 256) return tc_occupancy<256>(narrow, ctas_per_sm, smem_bytes);
    return tc_occupancy<576>(narrow, ctas_per_sm, smem_bytes);
  }
  if (D <= 32) return f32_occupancy<32>(narrow, ctas_per_sm, smem_bytes);
  if (D <= 64) return f32_occupancy<64>(narrow, ctas_per_sm, smem_bytes);
  if (D <= 128) return f32_occupancy<128>(narrow, ctas_per_sm, smem_bytes);
  if (D <= 256) return f32_occupancy<256>(narrow, ctas_per_sm, smem_bytes);
  return f32_occupancy<576>(narrow, ctas_per_sm, smem_bytes);
}

}  // extern "C"
