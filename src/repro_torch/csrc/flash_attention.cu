// Blocked GQA attention for Hopper (prefill and the bidirectional encoder):
// the Pallas TPU kernel src/repro/kernels/flash_attention.py `_kernel`
// (pallas_call :93), forward only.
//
// q (B, K, G, S, D), k and v (B, K, T, D), f32 or bf16, any strides with a
// unit stride on D (the model's (B, S, H, D) projections and the (B, T, K, D)
// cache are read in place, no transposed copy).  For query position s and
// key t of the same (b, kv-head): score = (q . k) * scale, allowed where
// t < T, and t <= s when causal, and t > s - window when window > 0.  Output
// = softmax over the allowed keys . v, finalised as acc / max(l, 1e-37), in
// q's dtype.  bf16 inputs are converted to f32 at staging; all arithmetic is
// plain FP32 (no TF32, no tensor cores: the reference holds the kernel to
// 2e-5 in f32, and memori-agent is an f32 model).
//
// What bounds it: operations.  Causal prefill of S tokens does
// 2 * 2 * K * G * D * S(S+1)/2 flops against (2 K T + 2 K G S) * D * 4 bytes:
// at the long-context shape (K=4, G=3, S=T=4096, D=64) 25.8 GFLOP, 0.39 ms
// at 67 TFLOP/s of non-tensor-core FP32, against 25 MB (7.5 us) of memory.
// At the agent's prefill (S ~ 150) the work is a few microseconds and the
// launch is the cost.
//
// Design (not the TPU grid: Pallas walks the kv axis in order inside one
// core, keeping m, l and acc in VMEM scratch between grid steps):
//   * one CTA per (64 query rows, kv-head, batch row), 128 threads.  Query
//     rows are the (s, g) pairs of the kv-head flattened s-major, so a CTA
//     holds ~64/G consecutive positions of all G grouped heads: every K/V
//     tile staged in shared memory serves all G heads (why GQA exists, and
//     why the TPU kernel put G inside its block), for any G;
//   * a loop over 64-key tiles inside the CTA replaces the sequential kv
//     grid axis; with causal masking it stops at the CTA's last position
//     (tiles above the diagonal are never read), with a window it starts at
//     the first tile any of its rows can see;
//   * each thread owns a 4-row x 8-key block of scores (an FMA product over
//     D read from shared memory) and the same 4 rows x D/8 columns of the
//     output accumulator, so the running max m, the running sum l and acc
//     live in registers; the 8 threads sharing a row are lanes of one warp
//     and reduce the row max and sum with shuffles.  Masked scores get
//     exactly zero weight (p = 0), never a place in the max.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;    // query rows per CTA
constexpr int kKeys = 64;    // keys per tile
constexpr int kRowsPerThread = 4;
constexpr int kColGroups = 8;  // threads sharing one row
constexpr float kNegInf = -2.0e38f;

static_assert(kRows == (kThreads / kColGroups) * kRowsPerThread,
              "row groups x rows per thread cover the CTA's rows");
static_assert(kKeys % kColGroups == 0, "keys are dealt evenly to a row's threads");

struct Strides {  // element strides; D has stride 1
  long long q[4];  // b, k, g, s
  long long k[3];  // b, k, t
  long long v[3];  // b, k, t
  long long o[4];  // b, k, g, s
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kRows * (DP + 1)      // Q tile
                          + (size_t)kKeys * (DP + 1)    // K tile
                          + (size_t)kKeys * DP          // V tile
                          + (size_t)kRows * (kKeys + 1));  // probabilities
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int G, int S,
                 int T_len, int D, float scale, int causal, int window,
                 Strides st) {
  constexpr int kCols = kKeys / kColGroups;  // keys per thread per tile
  constexpr int kDCols = DP / kColGroups;    // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kRows * (DP + 1);
  float* Vs = Ks + kKeys * (DP + 1);
  float* Ps = Vs + kKeys * DP;

  const int tid = threadIdx.x;
  const int tx = tid % kColGroups;
  const int ty = tid / kColGroups;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int R = G * S;
  const int r0 = blockIdx.x * kRows;
  const T* qb = q + b * st.q[0] + kh * st.q[1];
  const T* kb = k + b * st.k[0] + kh * st.k[1];
  const T* vb = v + b * st.v[0] + kh * st.v[1];

  for (int i = tid; i < kRows * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, rr = r0 + r;
    float x = 0.f;
    if (rr < R && d < D) x = to_f32(qb[(rr % G) * st.q[2] + (rr / G) * st.q[3] + d]);
    Qs[r * (DP + 1) + d] = x;
  }

  int pos[kRowsPerThread];  // query position of each owned row, -1 past the end
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int rr = r0 + ty * kRowsPerThread + i;
    pos[i] = rr < R ? rr / G : -1;
  }
  const int s_lo = r0 / G;
  const int s_hi = (min(r0 + kRows, R) - 1) / G;
  const int t_end = causal ? min(T_len, s_hi + 1) : T_len;
  int t_begin = window > 0 ? max(0, s_lo - window + 1) : 0;
  t_begin -= t_begin % kKeys;

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kDCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += kKeys) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kKeys * DP; i += kThreads) {
      const int j = i / DP, d = i % DP, t = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < T_len && d < D) {
        kx = to_f32(kb[t * st.k[2] + d]);
        vx = to_f32(vb[t * st.v[2] + d]);
      }
      Ks[j * (DP + 1) + d] = kx;
      Vs[j * DP + d] = vx;
    }
    __syncthreads();

    float sc[kRowsPerThread][kCols];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {  // zero padding past D adds exact zeros
      float qv[kRowsPerThread], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = Qs[(ty * kRowsPerThread + i) * (DP + 1) + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = Ks[(tx + kColGroups * c) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int s = pos[i];
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int t = t0 + tx + kColGroups * c;
        ok[c] = s >= 0 && t < T_len && (!causal || t <= s) && (window <= 0 || t > s - window);
        sc[i][c] *= scale;
        if (ok[c]) mx = fmaxf(mx, sc[i][c]);
      }
#pragma unroll
      for (int off = 1; off < kColGroups; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = ok[c] ? expf(sc[i][c] - m_new) : 0.f;
        sum += p;
        Ps[(ty * kRowsPerThread + i) * (kKeys + 1) + tx + kColGroups * c] = p;
      }
#pragma unroll
      for (int off = 1; off < kColGroups; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    const int n_keys = min(kKeys, T_len - t0);
    for (int j = 0; j < n_keys; ++j) {
      float p[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) p[i] = Ps[(ty * kRowsPerThread + i) * (kKeys + 1) + j];
#pragma unroll
      for (int c = 0; c < kDCols; ++c) {
        const float vx = Vs[j * DP + tx + kColGroups * c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i][c] = fmaf(p[i], vx, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int rr = r0 + ty * kRowsPerThread + i;
    if (rr >= R) continue;
    T* ob = out + b * st.o[0] + kh * st.o[1] + (rr % G) * st.o[2] + (rr / G) * st.o[3];
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < kDCols; ++c) {
      const int d = tx + kColGroups * c;
      if (d < D) store(ob + d, acc[i][c] / denom);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int K, int G, int S, int T_len, int D, float scale, int causal,
                   int window, const Strides& st, cudaStream_t stream) {
  static int attr_device = -1;  // the shared-memory ceiling is per device
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != attr_device) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<DP>());
    if (err != cudaSuccess) return err;
    attr_device = device;
  }
  const dim3 grid((G * S + kRows - 1) / kRows, K, B);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem_bytes<DP>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), G, S, T_len, D, scale, causal, window, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* out,
                         int B, int K, int G, int S, int T_len, int D, float scale,
                         int causal, int window, const Strides& st,
                         cudaStream_t stream) {
  if (D <= 32) return launch<T, 32>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, st, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, st, stream);
  if (D <= 128) return launch<T, 128>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, st, stream);
  return launch<T, 256>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, st, stream);
}

}  // namespace

extern "C" {

// Largest head dimension the kernel takes.
int flash_attention_max_head_dim() { return 256; }

// Launch on `stream`.  dtype 0 = f32, 1 = bf16 (q, k, v and out alike).
// `strides` holds 14 element strides: q (b, k, g, s), k (b, k, t),
// v (b, k, t), out (b, k, g, s).  Returns the CUDA error code (0 on
// success).
int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                           void* out, int B, int K, int G, int S, int T_len, int D,
                           float scale, int causal, int window,
                           const long long* strides, void* stream) {
  if (B < 0 || K < 0 || G < 0 || S < 0 || T_len < 1 || D < 1 || D > 256 ||
      window < 0 || strides == nullptr || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0 || G == 0 || S == 0) return 0;
  if (K > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 4; ++i) st.q[i] = strides[i];
  for (int i = 0; i < 3; ++i) st.k[i] = strides[4 + i];
  for (int i = 0; i < 3; ++i) st.v[i] = strides[7 + i];
  for (int i = 0; i < 4; ++i) st.o[i] = strides[10 + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_dtype<float>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, st, s)
                 : launch_dtype<__nv_bfloat16>(q, k, v, out, B, K, G, S, T_len, D, scale, causal, window, st, s);
  return (int)err;
}

}  // extern "C"
