// Staging rows of a (B, H, T, hd) float32 or bfloat16 view by TMA, shared by B.7's
// forward (wkv6.cu) and its backward (wkv6_bwd.cu): the mbarrier helpers,
// one tensor copy of a box of rows, and the tensor map of a view given by
// its strides (cuTensorMapEncodeTiled from the CUDA driver through the runtime,
// no -lcuda).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Strides {
  long long b, h, t;  // batch, head and time strides; head dims are contiguous
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// thread 0: expect `bytes` more on bar (one arrival of its count of 1)
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// every thread: wait for bar's phase `parity` to complete; a copy that never
// lands traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 24)) __trap();
  }
}

// thread 0: the map's box of rows from row t0 on of (head, batch) into dst
// (dense; rows past T zero-filled), counted on bar.  The caller announces
// the bytes on bar and, after a CTA barrier that orders every read of dst
// before these writes, fences the async proxy.
__device__ __forceinline__ void tma_rows(float* dst, const CUtensorMap* map, int t0, int head,
                                         int batch, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(t0), "r"(head), "r"(batch),
      "r"(smem_addr(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, from the CUDA driver through the runtime (no -lcuda),
// or null where the CUDA driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A TMA map of a (B, H, T, hd) float32 view given by its strides, copied
// box_rows rows at a time: 1 when mapped, 0 where a row is not on 16 bytes
// (the caller loads with plain loads), -1 where the CUDA driver has no encoder
// or refuses the map.
int rows_map(CUtensorMap* map, const float* base, long long B, long long H, long long T,
             long long hd, const Strides& s, int box_rows) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || s.b % 4 != 0 || s.h % 4 != 0 ||
      s.t % 4 != 0)
    return 0;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.t) * 4,
                                 static_cast<cuuint64_t>(s.h) * 4,
                                 static_cast<cuuint64_t>(s.b) * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(hd), static_cast<cuuint32_t>(box_rows), 1,
                             1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                 CUDA_SUCCESS
             ? 1
             : -1;
}

// The same for a bfloat16 view: rows on 16 bytes (strides multiples of 8
// elements), boxes of hd x box_rows bfloat16 values.
int rows_map_bf16(CUtensorMap* map, const void* base, long long B, long long H, long long T,
                  long long hd, const Strides& s, int box_rows) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || s.b % 8 != 0 || s.h % 8 != 0 ||
      s.t % 8 != 0)
    return 0;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.t) * 2,
                                 static_cast<cuuint64_t>(s.h) * 2,
                                 static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(hd), static_cast<cuuint32_t>(box_rows), 1,
                             1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                 CUDA_SUCCESS
             ? 1
             : -1;
}

}  // namespace
