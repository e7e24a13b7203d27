// Helpers shared by decode_attention.cu (K5) and flash_attention.cu (K6):
// element conversion, float4 reads of shared-memory rows, 16-byte cp.async
// and the K/V tile copy (the f32 kernels); mbarriers, tensor-map copies and
// their host-side descriptors, bf16 tensor-core fragments (the bf16 ones).  kernels/build.py hashes this header with
// each source that includes it, so an edit here rebuilds both.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
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

// threads sharing a row when a bf16 kernel stages rows by plain loads
constexpr int kCopyTPR = 8;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// -- mbarriers (Hopper): a stage's tile has landed ----------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// after every mbar_init, before any thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of async copies into the phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a 16-byte multiple, both addresses 16-byte aligned) from global
// to shared memory in one bulk copy, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, counted on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, int c0, int c1, int c2,
                                            int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// -- bf16 tensor-core fragments (mma.sync m16n8k16, f32 accumulators) --------
//
// A warp's 16 x 16 A tile: 4 registers of two bf16 (a0: row g = lane / 4,
// columns 2t, 2t + 1 with t = lane % 4; a1: row g + 8; a2, a3: the same
// rows, columns + 8).  A 16 x 8 B tile (K x N, "col"): 2 registers (b0:
// rows 2t, 2t + 1 of column g; b1: rows + 8).  A 16 x 8 f32 accumulator:
// 4 floats (c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8).

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives row l / 4, elements 2 (l % 4), +1 of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// the same, each matrix transposed: row 2 (l % 4) and 2 (l % 4) + 1 of column l / 4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a . b, bf16 operands, f32 accumulation (registers only: not
// volatile, so the compiler may schedule it around the ldmatrix loads)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x by the SFU (ex2.approx.ftz: ~2 ulp; 2^-inf = +0, so a score set to
// -inf gets exactly zero weight)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// two floats as a bf16 pair (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a (B, K, T, D) bf16 operand read through its element
// strides (b, k, t), boxes of 64 columns x `rows` keys, 128-byte swizzled
// (as the tile's ldmatrix reads undo it).  False when
// cuTensorMapEncodeTiled cannot describe it (then the kernel stages by plain
// loads)
bool tile_map(CUtensorMap* map, const void* base, int B, int K, int T_len, int D,
              const long long* strides, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T_len, (cuuint64_t)K, (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * 2, (cuuint64_t)strides[1] * 2,
                               (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, bytes, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
