// Device helpers shared by decode_attention.cu (K5) and flash_attention.cu
// (K6): element conversion, float4 reads of shared-memory rows, 16-byte
// cp.async and the K/V tile copy.  kernels/build.py hashes this header with
// each source that includes it, so an edit here rebuilds both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// four consecutive elements of a shared-memory row as floats
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s))));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [t0, t0 + rows) of one kv-head's K and V (row strides sk, sv)
// into a pair of shared-memory tiles of RS-element rows: 16-byte cp.async
// when `vec` (D * sizeof(T), the strides and the bases are 16-byte
// multiples), else plain loads.  Commits one cp.async group either way.
template <typename T, int RS, int kNThreads>
__device__ __forceinline__ void stage_tile(T* Ks, T* Vs, const T* kb, const T* vb,
                                           long long sk, long long sv, int t0, int rows,
                                           int D, int vec, int tid) {
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(T);
    const int cpr = D / kPer, per_op = rows * cpr;
    for (int i = tid; i < 2 * per_op; i += kNThreads) {
      const int which = i / per_op, r = i % per_op;
      const int row = r / cpr, c = r % cpr;
      const long long t = t0 + row;
      const T* src = which ? vb + t * sv : kb + t * sk;
      cp_async16((which ? Vs : Ks) + row * RS + c * kPer, src + c * kPer);
    }
  } else {
    for (int i = tid; i < rows * D; i += kNThreads) {
      const int row = i / D, d = i % D;
      const long long t = t0 + row;
      Ks[row * RS + d] = kb[t * sk + d];
      Vs[row * RS + d] = vb[t * sv + d];
    }
  }
  cp_async_commit();
}

}  // namespace
