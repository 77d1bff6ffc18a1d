// Fused dequantize-accumulate of the compressed gossip wire, for Hopper
// (sm_90a), with the one-card ppermute folded in.
//
// Replaces the Pallas TPU kernel `_dequant_acc_kernel` / `dequant_accumulate`
// (B.3) of src/repro/kernels/quant_gossip/kernel.py.  (Its link-masked twin
// B.5 is masked_grouped.cu.)  For every row i of a (K, D) float32
// accumulator, with an int8 payload q and per-(row, block) float32 scales:
//
//     a       = w[i]
//     r       = src[i]                  (the row node i receives from;
//                                        i itself when src is null)
//     out[i,j] = acc[i,j] + (a * scales[r, j / block]) * q[r, j]
//
// in the multiplication order of the Pallas kernels, each product and the
// sum rounded once (__fmul_rn, __fadd_rn: nvcc would otherwise contract the
// multiply-add into an FMA), so the result is bit-equal to the plain
// PyTorch version (ref.py).  A row with a == 0 (an idle node of the
// matching) returns acc bitwise without
// reading the payload.  `src` is the reference's ppermute on one card: the
// kernel reads row src[i] of q and scales directly, so no per-matching copy
// of the payload is made; an out-of-range src traps.
//
// Bound: memory.  Per element the kernel reads acc (4 bytes) and q (1 byte)
// and writes out (4 bytes): 9 bytes against two multiplies and an add, far
// below the card's float32 ridge.  A row with a == 0 moves 8 bytes per
// element (acc read, out written).
//
// Design.  The TPU grid runs one program per (row, block); `_pick_block`
// leaves a ragged leaf one block per row, which would give the CNN's fc0/w
// (D = 512,000) 10 CTAs.  Here every row is cut into chunks of kChunk
// elements, one CTA each, with 16-byte loads of acc, 4-byte loads of q and
// 16-byte stores when the block length is a multiple of 4 (then four
// neighbouring elements share one scale).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr long long kChunk = kThreads * kPerThread;  // elements per CTA

__device__ __forceinline__ float acc_one(float acc, float as, signed char q) {
  return __fadd_rn(acc, __fmul_rn(as, static_cast<float>(q)));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dequant_acc_kernel(const float* __restrict__ acc, const int8_t* __restrict__ q,
                   const float* __restrict__ scales, const float* __restrict__ w,
                   const long long* __restrict__ src,
                   float* __restrict__ out, long long rows_q, long long d, long long block,
                   long long blocks_per_row, long long chunks_per_row) {
  const long long row = blockIdx.x / chunks_per_row;
  const long long begin = (blockIdx.x % chunks_per_row) * kChunk;
  const long long end = min(begin + kChunk, d);
  const float a = __ldg(w + row);
  const float* acc_r = acc + row * d;
  float* out_r = out + row * d;
  if (a == 0.0f) {  // nothing arrives on this row: out = acc, bitwise
    if (kVec) {
      for (long long i = begin + 4 * threadIdx.x; i < end; i += 4 * kThreads) {
        *reinterpret_cast<float4*>(out_r + i) =
            __ldg(reinterpret_cast<const float4*>(acc_r + i));
      }
    } else {
      for (long long i = begin + threadIdx.x; i < end; i += kThreads) out_r[i] = __ldg(acc_r + i);
    }
    return;
  }
  long long r = row;
  if (src != nullptr) {
    r = __ldg(src + row);
    if (r < 0 || r >= rows_q) __trap();
  }
  const int8_t* q_r = q + r * d;
  const float* s_r = scales + r * blocks_per_row;
  if (kVec) {  // block % 4 == 0: the four elements of a float4 share a scale
    for (long long i = begin + 4 * threadIdx.x; i < end; i += 4 * kThreads) {
      const float as = __fmul_rn(a, __ldg(s_r + i / block));
      const float4 av = __ldg(reinterpret_cast<const float4*>(acc_r + i));
      const char4 qv = *reinterpret_cast<const char4*>(q_r + i);
      float4 o;
      o.x = acc_one(av.x, as, qv.x);
      o.y = acc_one(av.y, as, qv.y);
      o.z = acc_one(av.z, as, qv.z);
      o.w = acc_one(av.w, as, qv.w);
      *reinterpret_cast<float4*>(out_r + i) = o;
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
      const float as = __fmul_rn(a, __ldg(s_r + i / block));
      out_r[i] = acc_one(__ldg(acc_r + i), as, q_r[i]);
    }
  }
}

int launch(const float* acc, const int8_t* q, const float* scales, const float* w,
           const long long* src, float* out, long long rows,
           long long rows_q, long long d, long long blocks_per_row, void* stream) {
  if (rows <= 0 || rows_q <= 0 || d <= 0 || blocks_per_row <= 0 || d % blocks_per_row != 0 ||
      (src == nullptr && rows_q != rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long block = d / blocks_per_row;
  const long long chunks_per_row = (d + kChunk - 1) / kChunk;
  const long long grid = rows * chunks_per_row;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = block % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g(static_cast<unsigned>(grid));
  if (vec) {
    dequant_acc_kernel<true><<<g, kThreads, 0, s>>>(acc, q, scales, w, src, out, rows_q, d,
                                                    block, blocks_per_row, chunks_per_row);
  } else {
    dequant_acc_kernel<false><<<g, kThreads, 0, s>>>(acc, q, scales, w, src, out, rows_q, d,
                                                     block, blocks_per_row, chunks_per_row);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// acc, out: (rows, d) float32; q: (rows_q, d) int8; scales: (rows_q,
// blocks_per_row) float32; w: (rows,) float32; src: (rows,) int64 in
// [0, rows_q), or null for src[i] = i (then rows_q == rows).  Launches on
// `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int dequant_accumulate_f32(const float* acc, const int8_t* q, const float* scales,
                                      const float* w, const long long* src, float* out,
                                      long long rows, long long rows_q, long long d,
                                      long long blocks_per_row, void* stream) {
  return launch(acc, q, scales, w, src, out, rows, rows_q, d, blocks_per_row, stream);
}
