// Blockwise int8 stochastic-rounding quantizer of the compressed consensus
// wire, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_quantize_kernel` / `quantize_blockwise`
// (B.2) of src/repro/kernels/quant_gossip/kernel.py.  (Its sender-masked
// twin B.4 is masked_grouped.cu.)  For every (row, block) of a (K, D)
// float32 array x, with uniforms u of the same shape:
//
//     scale = absmax(x[row, block]) / qmax          (1.0 if absmax is 0)
//     q     = clip(floor(x / scale + u), -qmax, qmax) as int8
//
// The result is bit-exact against the plain PyTorch version (ref.py) and the
// reference's jnp oracle given the same u: both divisions are correctly
// rounded (__fdiv_rn) and the add is a rounded add (__fadd_rn) that the
// compiler cannot contract into anything else.  Build without
// --use_fast_math and without -prec-div=false.
//
// Bound: memory.  Per element the kernel reads x and u (8 bytes) and writes q
// (1 byte); each (row, block) adds one 4-byte scale: about 9 bytes per
// element of HBM traffic against a handful of float operations, far below
// the card's ~20 FLOP/byte float32 ridge.
//
// Design.  The TPU grid runs one program per (row, block), which on this
// card would launch K CTAs for a leaf whose `_pick_block` fallback makes the
// whole row one block (the CNN's fc0/w: K = 10 rows of D = 512,000 on 132
// SMs).  Instead both passes split every (row, block) segment into chunks of
// kChunk elements, one CTA per chunk, so a large leaf fills the card:
//   pass 1  absmax: each CTA reduces |x| over its chunk (16-byte loads when
//           the block length allows) and combines into the segment's slot
//           with atomicMax on the float's bit pattern, which orders like the
//           value because |x| >= 0 (a NaN's bits exceed +inf's, so a NaN
//           propagates as jnp.max does).  The slots are zeroed by the caller.
//   pass 2  quantize: each CTA derives the segment's scale from the slot,
//           quantizes its chunk with 16-byte loads of x and u and a 4-byte
//           store of q; the first chunk's CTA writes the scale.
// x is read twice (once per pass); at the main path's leaf sizes the second
// read mostly hits the 50 MB L2.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;                     // four float4 per thread
constexpr long long kChunk = kThreads * kPerThread;  // elements per CTA

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned max4(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

__device__ __forceinline__ float segment_scale(unsigned absmax_bits, float qmax) {
  const float absmax = __uint_as_float(absmax_bits);
  return absmax > 0.0f ? __fdiv_rn(absmax, qmax) : 1.0f;
}

__device__ __forceinline__ signed char quantize_one(float x, float u, float scale,
                                                    float qmax) {
  float y = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  y = fminf(fmaxf(y, -qmax), qmax);
  return static_cast<signed char>(__float2int_rz(y));
}

// Which segment and which part of it a CTA covers.
struct Chunk {
  long long seg;    // (row, block) index, row-major
  long long begin;  // element offsets inside the segment
  long long end;
};

__device__ __forceinline__ Chunk chunk_of_cta(long long block, long long chunks_per_seg) {
  Chunk c;
  c.seg = blockIdx.x / chunks_per_seg;
  c.begin = (blockIdx.x % chunks_per_seg) * kChunk;
  c.end = min(c.begin + kChunk, block);
  return c;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ x, unsigned* __restrict__ absmax_bits,
              long long block, long long chunks_per_seg) {
  const Chunk c = chunk_of_cta(block, chunks_per_seg);
  const float* base = x + c.seg * block;
  unsigned m = 0u;
  if (kVec) {  // block % 4 == 0, so every offset here is a multiple of 4
    for (long long i = c.begin + 4 * threadIdx.x; i < c.end; i += 4 * kThreads) {
      m = max(m, max4(__ldg(reinterpret_cast<const float4*>(base + i))));
    }
  } else {
    for (long long i = c.begin + threadIdx.x; i < c.end; i += kThreads) {
      m = max(m, abs_bits(__ldg(base + i)));
    }
  }
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ unsigned warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
    for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (threadIdx.x == 0) atomicMax(absmax_bits + c.seg, m);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ u,
                const unsigned* __restrict__ absmax_bits, float qmax,
                int8_t* __restrict__ q, float* __restrict__ scales,
                long long block, long long chunks_per_seg) {
  const Chunk c = chunk_of_cta(block, chunks_per_seg);
  const long long off = c.seg * block;
  int8_t* qs = q + off;
  const float scale = segment_scale(absmax_bits[c.seg], qmax);
  if (c.begin == 0 && threadIdx.x == 0) scales[c.seg] = scale;
  const float* xs = x + off;
  const float* us = u + off;
  if (kVec) {
    for (long long i = c.begin + 4 * threadIdx.x; i < c.end; i += 4 * kThreads) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(xs + i));
      const float4 uv = __ldg(reinterpret_cast<const float4*>(us + i));
      char4 out;
      out.x = quantize_one(xv.x, uv.x, scale, qmax);
      out.y = quantize_one(xv.y, uv.y, scale, qmax);
      out.z = quantize_one(xv.z, uv.z, scale, qmax);
      out.w = quantize_one(xv.w, uv.w, scale, qmax);
      *reinterpret_cast<char4*>(qs + i) = out;
    }
  } else {
    for (long long i = c.begin + threadIdx.x; i < c.end; i += kThreads) {
      qs[i] = quantize_one(__ldg(xs + i), __ldg(us + i), scale, qmax);
    }
  }
}

int launch(const float* x, const float* u, float qmax, int8_t* q, float* scales,
           unsigned* absmax_scratch, long long rows, long long d, long long block,
           void* stream) {
  if (rows <= 0 || d <= 0 || block <= 0 || d % block != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks_per_row = d / block;
  const long long segments = rows * blocks_per_row;
  const long long chunks_per_seg = (block + kChunk - 1) / kChunk;
  const long long grid = segments * chunks_per_seg;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = block % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g(static_cast<unsigned>(grid));
  if (vec) {
    absmax_kernel<true><<<g, kThreads, 0, s>>>(x, absmax_scratch, block, chunks_per_seg);
  } else {
    absmax_kernel<false><<<g, kThreads, 0, s>>>(x, absmax_scratch, block, chunks_per_seg);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec) {
    quantize_kernel<true><<<g, kThreads, 0, s>>>(x, u, absmax_scratch, qmax, q, scales, block,
                                                 chunks_per_seg);
  } else {
    quantize_kernel<false><<<g, kThreads, 0, s>>>(x, u, absmax_scratch, qmax, q, scales,
                                                  block, chunks_per_seg);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, u: (rows, d) float32; q: (rows, d) int8; scales: (rows, d / block)
// float32; absmax_scratch: (rows, d / block) 32-bit words, zeroed by the
// caller.  `block` divides d.  Launches on `stream`; returns the
// cudaError_t of the launches (0 on success).
extern "C" int quantize_blockwise_f32(const float* x, const float* u, float qmax,
                                      int8_t* q, float* scales,
                                      unsigned* absmax_scratch, long long rows,
                                      long long d, long long block, void* stream) {
  return launch(x, u, qmax, q, scales, absmax_scratch, rows, d, block, stream);
}
