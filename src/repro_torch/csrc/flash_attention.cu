// Blocked GQA attention for Hopper (prefill and the bidirectional encoder):
// the Pallas TPU kernel src/repro/kernels/flash_attention.py `_kernel`
// (pallas_call :93), forward only.
//
// q (B, K, G, S, D), k and v (B, K, T, D), f32 or bf16, any strides with a
// unit stride on D (the model's (B, S, H, D) projections and the (B, T, K, D)
// cache are read in place, no transposed copy).  For query position s and
// key t of the same (b, kv-head): score = (q . k) * scale, allowed where
// t < T, and t <= s (or t < prefix_len, the prefix-LM mask of an image
// prefix) when causal, and t > s - window when window > 0.  Output
// = softmax over the allowed keys . v, finalised as acc / max(l, 1e-37), in
// q's dtype (0 for a query with no allowed key).  bf16 converts on the way
// out of shared memory; all arithmetic is plain FP32 (no TF32, no tensor
// cores: the reference holds the kernel to 2e-5 in f32, and memori-agent is
// an f32 model).
//
// What bounds it: operations.  Causal prefill of S tokens does
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

template <typename T, int DP, int RT, int RG, int KC>
__global__ void __launch_bounds__(RG * kKeyGroups, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int K, int B, int G,
                 int S, int T_len, int D, float scale, int causal, int window,
                 int prefix_len, const int* __restrict__ prefix_rows, int vec, Strides st) {
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
  // the prefix: keys t < P are visible to every row (causal only)
  const int P = prefix_rows != nullptr ? prefix_rows[b] : prefix_len;
  const int t_end = causal ? min(T_len, max(s_hi + 1, P)) : T_len;
  int t_begin = window > 0 ? max(0, s_lo - window + 1) : 0;
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
        ok[c] = s >= 0 && t < T_len && (!causal || t <= s || t < P) &&
                (window <= 0 || t > s - window);
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

template <typename T, int DP, bool kNarrow>
cudaError_t launch_shape(int device, const void* q, const void* k, const void* v, void* out,
                         int B, int K, int G, int S, int T_len, int D, float scale, int causal,
                         int window, int prefix_len, const int* prefix_rows, int vec,
                         const Strides& st, cudaStream_t stream, int* rows_per_cta) {
  using Sh = Shape<DP, kNarrow>;
  using C = Cfg<T, DP, Sh::RT, Sh::RG, Sh::KC>;
  static int attr_device = -1;  // the shared-memory ceiling is per device
  if (device != attr_device) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_fwd_kernel<T, DP, Sh::RT, Sh::RG, Sh::KC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return err;
    attr_device = device;
  }
  const long long blocks = (long long)((G * S + C::kRows - 1) / C::kRows) * K * B;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, DP, Sh::RT, Sh::RG, Sh::KC><<<(unsigned)blocks, C::kThreads, C::kSmem,
                                                   stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), K, B, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows,
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
                      int prefix_len, const int* prefix_rows, int vec, const Strides& st,
                      cudaStream_t s, int* rows_per_cta) {
  int device;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  constexpr int kWideRows = Shape<DP, false>::RT * Shape<DP, false>::RG;
  const long long wide = (long long)((G * S + kWideRows - 1) / kWideRows) * K * B;
  if (wide >= sm_count(device))
    return launch_shape<T, DP, false>(device, q, k, v, out, B, K, G, S, T_len, D, scale,
                                      causal, window, prefix_len, prefix_rows, vec, st, s,
                                      rows_per_cta);
  return launch_shape<T, DP, true>(device, q, k, v, out, B, K, G, S, T_len, D, scale, causal,
                                   window, prefix_len, prefix_rows, vec, st, s, rows_per_cta);
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* out, int B, int K,
                         int G, int S, int T_len, int D, float scale, int causal, int window,
                         int prefix_len, const int* prefix_rows, int vec, const Strides& st,
                         cudaStream_t s, int* rows_per_cta) {
  if (D <= 32) return launch_dp<T, 32>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, vec, st, s, rows_per_cta);
  if (D <= 64) return launch_dp<T, 64>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, vec, st, s, rows_per_cta);
  if (D <= 128) return launch_dp<T, 128>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, vec, st, s, rows_per_cta);
  if (D <= 256) return launch_dp<T, 256>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, vec, st, s, rows_per_cta);
  return launch_dp<T, 576>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, prefix_len, prefix_rows, vec, st, s, rows_per_cta);
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
// t < prefix_len are visible to every query row (0: none).  On a launch,
// writes the rows per CTA of the shape it launched to `rows_per_cta` unless
// that is null.  Returns the CUDA error code (0 on success).
int flash_attention_launch(int dtype, const void* q, const void* k, const void* v, void* out,
                           int B, int K, int G, int S, int T_len, int D, float scale,
                           int causal, int window, int prefix_len, const int* prefix_rows,
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
                                       prefix_len, prefix_rows, vec, st, s, rows_per_cta)
                 : launch_dtype<__nv_bfloat16>(q, k, v, out, B, K, G, S, T_len, D, scale, causal,
                                               window, prefix_len, prefix_rows, vec, st, s,
                                               rows_per_cta);
  return (int)err;
}

}  // extern "C"
