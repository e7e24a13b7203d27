// Flash-decode for Hopper: one query token per (batch row, kv-head) group
// against a KV cache — the Pallas TPU kernel
// src/repro/kernels/decode_attention.py `_kernel` (pallas_call :80).
//
// q (B, K, G, D), k and v (B, K, T, D), f32 or bf16, any strides with a unit
// stride on D (the engine's (B, T, K, D) per-layer cache is read in place);
// kv_len (B,) int32 on the device.  For batch row b the allowed keys are the
// positions t < kv_len[b] (and t > kv_len[b] - 1 - window when window > 0);
// output = softmax(q . k * scale) over them . v, finalised as
// acc / max(l, 1e-37), in q's dtype.  Cache rows past kv_len (stale rows of
// an earlier occupant of the slot) are never read.  bf16 converts at
// staging; all arithmetic is plain FP32.
//
// What bounds it: bytes.  Each allowed cache row is read once for all G
// heads, 2 * D * 4 bytes per (row, kv-head) in f32, against 4 * G * D flops:
// G/2 flops per byte, far below the card's ~20 FP32 flops per byte.  At the
// agent's decode step (8 slots, K=4, kv_len ~150-200, D=64) that is ~3 MB,
// ~1 us at 3.35 TB/s, so a launch costs more than the work.
//
// Design (the TPU kernel walks T in order inside one core; a CTA per
// (b, kv-head) would leave most of 132 SMs idle at 8 slots x 4 kv-heads):
//   pass 1  grid (T-split, kv-head, batch row).  Each CTA reads kv_len[b]
//           on the device and returns at once when its split of T holds no
//           allowed position; otherwise it streams its split in 64-row tiles
//           through shared memory, computes the G x 64 scores, updates the
//           per-head running max and sum (one warp per head, shuffles) and
//           the G x D accumulator (registers), and writes the split's
//           partial (m, l, acc) to scratch the wrapper allocates.
//   pass 2  one CTA per (kv-head, batch row) merges the splits' partials:
//           M = max m, L = sum l e^(m-M), out = sum acc e^(m-M) / max(L, 1e-37).
//           A split with no allowed position wrote l = 0 and is skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;   // cache rows per tile
constexpr int kMaxG = 16;   // query heads per kv-head
constexpr float kNegInf = -2.0e38f;

struct Strides {  // element strides; D has stride 1
  long long q[3];  // b, k, g
  long long k[3];  // b, k, t
  long long v[3];  // b, k, t
  long long o[3];  // b, k, g
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int DP>
constexpr size_t smem_floats(int G) {
  return (size_t)G * DP                 // queries
         + (size_t)kKeys * (DP + 1)     // K tile
         + (size_t)kKeys * DP           // V tile
         + (size_t)G * kKeys            // scores, then probabilities
         + 3 * (size_t)G;               // m, l, correction per head
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kv_len,
                      int G, int T_len, int D, float scale, int window, int chunk,
                      Strides st, float* __restrict__ part_ml,
                      float* __restrict__ part_acc) {
  constexpr int kAcc = (kMaxG * DP + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + G * DP;
  float* Vs = Ks + kKeys * (DP + 1);
  float* Ps = Vs + kKeys * DP;
  float* ms = Ps + G * kKeys;
  float* ls = ms + G;
  float* cs = ls + G;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const size_t part = ((size_t)(b * gridDim.y + kh) * n_split + split) * G;
  const int kl = kv_len[b];
  int lo = split * chunk;
  const int hi = min(lo + chunk, min(kl, T_len));
  if (window > 0) lo = max(lo, kl - window);
  if (lo >= hi) {  // no allowed position in this split
    for (int g = tid; g < G; g += kThreads) {
      part_ml[(part + g) * 2] = kNegInf;
      part_ml[(part + g) * 2 + 1] = 0.f;
    }
    return;
  }

  const T* qb = q + b * st.q[0] + kh * st.q[1];
  const T* kb = k + b * st.k[0] + kh * st.k[1];
  const T* vb = v + b * st.v[0] + kh * st.v[1];
  for (int i = tid; i < G * DP; i += kThreads) {
    const int g = i / DP, d = i % DP;
    Qs[i] = d < D ? to_f32(qb[g * st.q[2] + d]) : 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  for (int t0 = lo; t0 < hi; t0 += kKeys) {
    const int n = min(kKeys, hi - t0);
    __syncthreads();  // the previous tile is consumed (and Qs, ms, ls are set)
    for (int i = tid; i < kKeys * DP; i += kThreads) {
      const int j = i / DP, d = i % DP;
      float kx = 0.f, vx = 0.f;
      if (j < n && d < D) {
        kx = to_f32(kb[(t0 + j) * st.k[2] + d]);
        vx = to_f32(vb[(t0 + j) * st.v[2] + d]);
      }
      Ks[j * (DP + 1) + d] = kx;
      Vs[j * DP + d] = vx;
    }
    __syncthreads();
    for (int i = tid; i < G * kKeys; i += kThreads) {
      const int g = i / kKeys, j = i % kKeys;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) s = fmaf(Qs[g * DP + d], Ks[j * (DP + 1) + d], s);
      Ps[i] = s * scale;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {  // warp-uniform
      const float m_old = ms[g];
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, Ps[g * kKeys + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kKeys; j += 32) {
        const float p = j < n ? expf(Ps[g * kKeys + j] - m_new) : 0.f;
        Ps[g * kKeys + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int i = tid + a * kThreads;
      if (i < G * DP) {
        const int g = i / DP, d = i % DP;
        float x = acc[a] * cs[g];
        for (int j = 0; j < n; ++j) x = fmaf(Ps[g * kKeys + j], Vs[j * DP + d], x);
        acc[a] = x;
      }
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    part_ml[(part + g) * 2] = ms[g];
    part_ml[(part + g) * 2 + 1] = ls[g];
  }
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int i = tid + a * kThreads;
    if (i < G * DP) {
      const int g = i / DP, d = i % DP;
      if (d < D) part_acc[(part + g) * D + d] = acc[a];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int G, int D, int n_split, Strides st) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const size_t base = (size_t)(b * gridDim.x + kh) * n_split;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s) {
      const size_t p = (base + s) * G + g;
      if (part_ml[p * 2 + 1] > 0.f) M = fmaxf(M, part_ml[p * 2]);
    }
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t p = (base + s) * G + g;
      const float l = part_ml[p * 2 + 1];
      if (l > 0.f) {
        const float w = expf(part_ml[p * 2] - M);
        L = fmaf(l, w, L);
        A = fmaf(part_acc[p * D + d], w, A);
      }
    }
    store(out + b * st.o[0] + kh * st.o[1] + g * st.o[2] + d, A / fmaxf(L, 1e-37f));
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len,
                   void* out, int B, int K, int G, int T_len, int D, float scale,
                   int window, int n_split, int chunk, const Strides& st,
                   float* part_ml, float* part_acc, cudaStream_t stream) {
  static int attr_device = -1;  // the shared-memory ceiling is per device
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != attr_device) {
    err = cudaFuncSetAttribute(decode_partial_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(smem_floats<DP>(kMaxG) * sizeof(float)));
    if (err != cudaSuccess) return err;
    attr_device = device;
  }
  decode_partial_kernel<T, DP><<<dim3(n_split, K, B), kThreads,
                                 smem_floats<DP>(G) * sizeof(float), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      kv_len, G, T_len, D, scale, window, chunk, st, part_ml, part_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(K, B), kThreads, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), G, D, n_split, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, const int* kv_len,
                         void* out, int B, int K, int G, int T_len, int D, float scale,
                         int window, int n_split, int chunk, const Strides& st,
                         float* part_ml, float* part_acc, cudaStream_t s) {
  if (D <= 32) return launch<T, 32>(q, k, v, kv_len, out, B, K, G, T_len, D, scale, window, n_split, chunk, st, part_ml, part_acc, s);
  if (D <= 64) return launch<T, 64>(q, k, v, kv_len, out, B, K, G, T_len, D, scale, window, n_split, chunk, st, part_ml, part_acc, s);
  if (D <= 128) return launch<T, 128>(q, k, v, kv_len, out, B, K, G, T_len, D, scale, window, n_split, chunk, st, part_ml, part_acc, s);
  return launch<T, 256>(q, k, v, kv_len, out, B, K, G, T_len, D, scale, window, n_split, chunk, st, part_ml, part_acc, s);
}

}  // namespace

extern "C" {

// Largest grouped-query count and head dimension the kernel takes.
int decode_attention_max_group() { return kMaxG; }
int decode_attention_max_head_dim() { return 256; }

// Launch both passes on `stream`.  dtype 0 = f32, 1 = bf16 (q, k, v and out
// alike).  `strides` holds 12 element strides: q (b, k, g), k (b, k, t),
// v (b, k, t), out (b, k, g).  The cache's T axis is cut into n_split splits
// of `chunk` rows (n_split * chunk >= T); part_ml holds B*K*n_split*G*2 and
// part_acc B*K*n_split*G*D floats.  Returns the CUDA error code (0 on
// success).
int decode_attention_launch(int dtype, const void* q, const void* k, const void* v,
                            const int* kv_len, void* out, int B, int K, int G,
                            int T_len, int D, float scale, int window, int n_split,
                            int chunk, const long long* strides, float* part_ml,
                            float* part_acc, void* stream) {
  if (B < 0 || K < 0 || G < 0 || G > kMaxG || T_len < 1 || D < 1 || D > 256 ||
      window < 0 || n_split < 1 || chunk < 1 || (long long)n_split * chunk < T_len ||
      strides == nullptr || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0 || G == 0) return 0;
  if (K > 65535 || B > 65535 || kv_len == nullptr || part_ml == nullptr ||
      part_acc == nullptr)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_dtype<float>(q, k, v, kv_len, out, B, K, G, T_len, D, scale, window, n_split, chunk, st, part_ml, part_acc, s)
                 : launch_dtype<__nv_bfloat16>(q, k, v, kv_len, out, B, K, G, T_len, D, scale, window, n_split, chunk, st, part_ml, part_acc, s);
  return (int)err;
}

}  // extern "C"
