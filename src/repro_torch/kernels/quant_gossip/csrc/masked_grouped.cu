// The int8 gossip wire's grouped kernels, over every leaf of a parameter
// tree, for Hopper (sm_90a): one launch quantizes every leaf of one
// matching or round (B.4, and B.2, which is B.4 without a mask), one launch
// accumulates every leaf of one matching (B.5, and B.3, which is B.5
// without a mask).
//
// Replaces four Pallas TPU kernels of src/repro/kernels/quant_gossip/kernel.py:
//   `_quantize_kernel` / `quantize_blockwise` (B.2),
//   `_masked_quantize_kernel` / `masked_quantize_blockwise` (B.4),
//   `_masked_dequant_acc_kernel` / `masked_dequant_accumulate` (B.5), and
//   `_dequant_acc_kernel` / `dequant_accumulate` (B.3).
//
// B.4, for every leaf l, row i and block b of a (K, D_l) float32 x_l with
// uniforms u_l and one sender mask m (K,) in {0, 1}:
//
//     scale = absmax(x_l[i, b]) / qmax                  (1.0 if absmax is 0)
//     q     = clip(floor(x_l / scale + u_l), -qmax, qmax) as int8
//     scales_l[i, b] = scale * m[i]
//
// and a masked row (m[i] <= 0) writes q = 0 and scale 0 without reading x or
// u.  B.2 is the same launch with a null mask, m = 1: scale * 1 is scale
// exactly, so B.2 and B.4 share one kernel bit for bit.  B.5, in place,
// for every leaf l and row i with a = m[i] * w[i] != 0 and r = src[i] (i
// itself when src is null):
//
//     acc_l[i, j] += (a * scales_l[r, j / block_l]) * q_l[r, j]
//
// a row with a == 0 is skipped outright: its acc already holds the answer.
// B.3 is the same launch with a null mask, a = w[i]: with m = 1, m * w is
// w exactly, so B.3 and B.5 share one kernel bit for bit.
//
// Bits: both divisions are correctly rounded (__fdiv_rn), the adds and
// products rounded once each (__fadd_rn, __fmul_rn: no contraction into an
// FMA), and a maximum does not depend on the order it is taken in, so both
// kernels are bit-equal to the plain PyTorch versions (ref.py).  Build
// without --use_fast_math and without -prec-div=false.
//
// Bound: memory.  B.4 reads x and u (8 bytes per element) and writes q (1
// byte) plus a 4-byte scale per block; B.5 and B.3 read acc and q and
// write acc (9 bytes).  All do a handful of float operations per element, far below
// the card's float32 ridge.  At the fmnist MLP's widths (K = 10, 6 leaves,
// 1.07 M elements) that is 2.94 us at 3.35 TB/s, which is below the cost of
// launching one kernel per leaf: the per-leaf design (a scratch fill, an
// absmax pass and a quantize pass per leaf, 18 device ops per matching) ran
// at 29.8 us for B.4 and 12.9 us for B.5 per matching on an H100, and B.2's
// (the same three per leaf) at 26.3 us per round.
//
// Design.
// * Grouping.  The leaves of one call go to the kernel by value, as a
//   __grid_constant__ table (pointers, row length, block length, the prefix
//   count of the leaf's work units); a CTA finds its leaf by a scan of at
//   most kMaxLeaves entries.  Larger groups are split by the caller.
// * B.4: thread-block clusters of kCluster CTAs, launched with
//   cudaLaunchKernelEx.  A (leaf, row, block) segment longer than
//   kMinShare is one cluster's: each CTA takes a 1/kCluster share of it (at
//   least kMinShare elements; CTAs past the end only join the barriers),
//   reduces |x| over it on the float's bit pattern (|x| >= 0 orders like
//   its bits; a NaN's bits exceed +inf's, so a NaN propagates as jnp.max
//   does), and the cluster combines its partial maxima through distributed
//   shared memory (map_shared_rank after cluster.sync()).  A segment of at
//   most kMinShare elements is one CTA's whole, and a cluster packs
//   kCluster of them with no barrier: a cluster per short segment would
//   hold kCluster CTA slots for one CTA's work.  Each thread issues its
//   loads kUnroll float4 at a time, all in flight together.  A share of
//   one tile (kTile elements; the MLP's widest row is 13 CTAs of a tile)
//   keeps x and u in registers, u loaded before the cluster barrier; a
//   longer share keeps x in shared memory where it fits (kSmemCap floats),
//   else each CTA reads it again from L2 (the CNN's widest rows).  So x
//   crosses HBM once where the share fits: no scratch fill, no second
//   launch.  A closing cluster
//   barrier (arrived at right after the remote reads) keeps every CTA's
//   shared memory alive until the cluster has read it.  What bounds it at
//   the MLP's widths is in PERF.md (tests/b4_variants.py times variants of
//   this source on the card).
// * B.5 and B.3: a flat grid over (leaf, row, chunk of kChunk elements), in place,
//   16-byte loads and stores where the block length is a multiple of 4 and
//   the rows are aligned (the four elements then share a scale; a thread
//   issues all of its loads before its first store), scalar otherwise.
//   Each element is read and written by one thread and q is a separate
//   buffer, so updating acc in place is safe.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;           // B.5's CTA
constexpr int kQThreads = 512;          // B.4's CTA
constexpr int kQMinBlocks = 1024 / kQThreads;  // B.4 CTAs per SM the registers allow
constexpr int kCluster = 16;            // CTAs per B.4 cluster (non-portable size)
constexpr int kMaxLeaves = 16;          // leaves per launch
// B.4: a thread loads kUnroll float4 of x (and of u) at once, a CTA a tile
constexpr int kUnroll = 4;
constexpr long long kStride = 4 * kQThreads;
constexpr long long kTile = kStride * kUnroll;
constexpr long long kMinShare = kTile;  // B.4: fewest elements a CTA takes
constexpr long long kSmemCap = 12288;   // B.4: floats of x a CTA keeps (48 KB)
constexpr long long kChunk = kThreads * 16;  // B.5: elements per CTA
constexpr int kQuantDesc = 7;           // longs per leaf in a B.4 descriptor
constexpr int kAccDesc = 6;             // longs per leaf in a B.5 descriptor

// -- B.4 -----------------------------------------------------------------------

struct QuantLeaf {
  const float* x;
  const float* u;
  int8_t* q;
  float* scales;
  long long block;          // elements per segment
  long long bpr;            // blocks per row
  long long segments;       // rows * bpr
  long long cluster_begin;  // clusters of the launch's earlier leaves
  int vec;                  // 16-byte loads of x and u, 4-byte stores of q
};

struct QuantTable {
  QuantLeaf leaf[kMaxLeaves];
  const float* mask;
  float qmax;
  int n;
  long long smem_floats;  // the launch's shared-memory cache of x, per CTA
};

// A segment of at most kMinShare elements is one CTA's whole: a cluster
// then takes kCluster such segments, one per CTA ("packed").  A longer one
// is a cluster's, each CTA taking a share of at least kMinShare.
__host__ __device__ __forceinline__ bool packed(long long block) { return block <= kMinShare; }

__host__ __device__ __forceinline__ long long share_of(long long block) {
  if (packed(block)) return block;
  long long s = (block + kCluster - 1) / kCluster;
  s = s < kMinShare ? kMinShare : s;
  return (s + 3) & ~3LL;  // a multiple of 4 keeps every share 16-byte aligned
}

__host__ __device__ __forceinline__ long long clusters_of(long long segments,
                                                          long long block) {
  return packed(block) ? (segments + kCluster - 1) / kCluster : segments;
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned max4(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

__device__ __forceinline__ signed char quantize_one(float x, float u, float scale,
                                                    float qmax) {
  float y = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  y = fminf(fmaxf(y, -qmax), qmax);
  return static_cast<signed char>(__float2int_rz(y));
}

__device__ __forceinline__ unsigned warp_max(unsigned m) {
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One thread's kUnroll float4 of a tile: element offsets base + j * kStride.
__device__ __forceinline__ void load_tile(float4 (&v)[kUnroll], const float* p,
                                          long long base, long long end) {
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = base + j * kStride;
    if (i < end) v[j] = __ldg(reinterpret_cast<const float4*>(p + i));
  }
}

__device__ __forceinline__ void quantize_tile(const float4 (&xv)[kUnroll],
                                              const float4 (&uv)[kUnroll], int8_t* qs,
                                              long long base, long long end, float scale,
                                              float qmax) {
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = base + j * kStride;
    if (i < end) {
      char4 out;
      out.x = quantize_one(xv[j].x, uv[j].x, scale, qmax);
      out.y = quantize_one(xv[j].y, uv[j].y, scale, qmax);
      out.z = quantize_one(xv[j].z, uv[j].z, scale, qmax);
      out.w = quantize_one(xv[j].w, uv[j].w, scale, qmax);
      *reinterpret_cast<char4*>(qs + i) = out;
    }
  }
}

__global__ void __launch_bounds__(kQThreads, kQMinBlocks)
masked_quantize_grouped_kernel(const __grid_constant__ QuantTable t) {
  extern __shared__ float4 cache4[];
  float* cache = reinterpret_cast<float*>(cache4);
  __shared__ unsigned warp_part[kQThreads / 32];
  __shared__ unsigned cta_max;  // this CTA's partial, read by the whole cluster
  __shared__ unsigned seg_max;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long c = blockIdx.x / kCluster;
  int l = 0;
  while (l + 1 < t.n && c >= t.leaf[l + 1].cluster_begin) ++l;
  const QuantLeaf& L = t.leaf[l];
  // the segment (row * bpr + block, row-major) and this CTA's part of it
  const bool whole = packed(L.block);
  const long long local = whole ? (c - L.cluster_begin) * kCluster + rank
                                : c - L.cluster_begin;
  if (local >= L.segments) return;  // the last packed cluster's spare CTAs
  const long long row = local / L.bpr;
  const long long share = share_of(L.block);
  const long long n_act = (L.block + share - 1) / share;  // CTAs with elements
  const long long begin = whole ? 0 : rank * share;
  const long long end = min(begin + share, L.block);
  const long long off = local * L.block;
  int8_t* qs = L.q + off;

  // Every decision below that leads to a cluster barrier is the same for
  // every CTA of the cluster (a packed cluster's CTAs reach none): a
  // cluster barrier is reached by all of its CTAs or by none.
  const float m = t.mask == nullptr ? 1.0f : __ldg(t.mask + row);  // B.2: no mask
  if (!(m > 0.0f)) {  // masked sender: zero payload, zero scale
    if (begin == 0 && threadIdx.x == 0) L.scales[local] = 0.0f;
    if (L.vec) {
      for (long long i = begin + 4 * threadIdx.x; i < end; i += kStride) {
        *reinterpret_cast<char4*>(qs + i) = make_char4(0, 0, 0, 0);
      }
    } else {
      for (long long i = begin + threadIdx.x; i < end; i += kQThreads) qs[i] = 0;
    }
    return;
  }

  // phase 1: |x| over this CTA's share.  Loads go kUnroll float4 at a time
  // per thread, all in flight together.  A share of one tile keeps x and u
  // in registers (u is loaded before the cluster barrier); a longer share
  // keeps x in shared memory where it fits, else phase 2 reads it from L2.
  const float* xs = L.x + off;
  const float* us = L.u + off;
  const bool one_tile = end - begin <= kTile;
  const bool cached = !one_tile && end - begin <= t.smem_floats;
  const long long base0 = begin + 4 * threadIdx.x;
  float4 x0[kUnroll], u0[kUnroll];
  unsigned mx = 0u;
  if (L.vec && one_tile) {
    load_tile(x0, xs, base0, end);
    load_tile(u0, us, base0, end);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (base0 + j * kStride < end) mx = max(mx, max4(x0[j]));
    }
  } else if (L.vec) {
    for (long long base = base0; base < end; base += kTile) {
      float4 v[kUnroll];
      load_tile(v, xs, base, end);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long i = base + j * kStride;
        if (i < end) {
          if (cached) cache4[(i - begin) >> 2] = v[j];
          mx = max(mx, max4(v[j]));
        }
      }
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kQThreads) {
      const float v = __ldg(xs + i);
      if (end - begin <= t.smem_floats) cache[i - begin] = v;
      mx = max(mx, abs_bits(v));
    }
  }
  mx = warp_max(mx);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x < 32) {
    mx = warp_max(threadIdx.x < kQThreads / 32 ? warp_part[threadIdx.x] : 0u);
    if (threadIdx.x == 0) {
      cta_max = mx;
      seg_max = mx;
    }
  }
  if (n_act > 1) {
    cluster.sync();  // every CTA's cta_max is written and visible
    if (threadIdx.x < 32) {
      unsigned v = threadIdx.x < kCluster
                       ? *cluster.map_shared_rank(&cta_max, static_cast<unsigned>(threadIdx.x))
                       : 0u;
      v = warp_max(v);
      if (threadIdx.x == 0) seg_max = v;
    }
    cluster_arrive();  // done reading the other CTAs' shared memory
  }
  __syncthreads();

  // phase 2: quantize this CTA's share
  const float absmax = __uint_as_float(seg_max);
  const float scale = absmax > 0.0f ? __fdiv_rn(absmax, t.qmax) : 1.0f;
  if (begin == 0 && threadIdx.x == 0) L.scales[local] = __fmul_rn(scale, m);
  if (!L.vec) {
    const bool in_smem = end - begin <= t.smem_floats;
    for (long long i = begin + threadIdx.x; i < end; i += kQThreads) {
      const float xv = in_smem ? cache[i - begin] : __ldg(xs + i);
      qs[i] = quantize_one(xv, __ldg(us + i), scale, t.qmax);
    }
  } else if (one_tile) {
    quantize_tile(x0, u0, qs, base0, end, scale, t.qmax);
  } else {
    for (long long base = base0; base < end; base += kTile) {
      float4 xv[kUnroll], uv[kUnroll];
      if (cached) {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const long long i = base + j * kStride;
          if (i < end) xv[j] = cache4[(i - begin) >> 2];
        }
      } else {
        load_tile(xv, xs, base, end);
      }
      load_tile(uv, us, base, end);
      quantize_tile(xv, uv, qs, base, end, scale, t.qmax);
    }
  }
  if (n_act > 1) cluster_wait();  // no CTA leaves while another may read its cta_max
}

// -- B.5 -----------------------------------------------------------------------

struct AccLeaf {
  float* acc;
  const int8_t* q;
  const float* scales;
  long long d;            // row length
  long long block;        // elements per scale
  long long bpr;          // blocks (scales) per row
  long long chunk_begin;  // CTAs of the launch's earlier leaves
  long long chunks;       // CTAs per row
  int vec;
};

struct AccTable {
  AccLeaf leaf[kMaxLeaves];
  const float* w;
  const float* mask;
  const long long* src;
  long long rows_q;
  int n;
};

__device__ __forceinline__ float acc_one(float acc, float as, signed char q) {
  return __fadd_rn(acc, __fmul_rn(as, static_cast<float>(q)));
}

__global__ void __launch_bounds__(kThreads)
masked_dequant_acc_grouped_kernel(const __grid_constant__ AccTable t) {
  const long long cta = blockIdx.x;
  int l = 0;
  while (l + 1 < t.n && cta >= t.leaf[l + 1].chunk_begin) ++l;
  const AccLeaf& L = t.leaf[l];
  const long long local = cta - L.chunk_begin;
  const long long row = local / L.chunks;
  const float a = t.mask == nullptr ? __ldg(t.w + row)  // B.3
                                    : __fmul_rn(__ldg(t.mask + row), __ldg(t.w + row));
  if (a == 0.0f) return;  // nothing arrives on this row: acc is the answer
  long long r = row;
  if (t.src != nullptr) {
    r = __ldg(t.src + row);
    if (r < 0 || r >= t.rows_q) __trap();
  }
  const long long begin = (local % L.chunks) * kChunk;
  const long long end = min(begin + kChunk, L.d);
  float* acc_r = L.acc + row * L.d;
  const int8_t* q_r = L.q + r * L.d;
  const float* s_r = L.scales + r * L.bpr;
  const float as_row = __fmul_rn(a, __ldg(s_r));  // one block per row: no division
  if (L.vec) {  // every load of the thread first, then every store
    constexpr int kPer = kChunk / (4 * kThreads);
    float4 v[kPer];
    char4 qv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long i = begin + 4 * (threadIdx.x + j * kThreads);
      if (i < end) {
        v[j] = *reinterpret_cast<const float4*>(acc_r + i);
        qv[j] = __ldg(reinterpret_cast<const char4*>(q_r + i));
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long i = begin + 4 * (threadIdx.x + j * kThreads);
      if (i < end) {
        const float as = L.bpr == 1 ? as_row : __fmul_rn(a, __ldg(s_r + i / L.block));
        v[j].x = acc_one(v[j].x, as, qv[j].x);
        v[j].y = acc_one(v[j].y, as, qv[j].y);
        v[j].z = acc_one(v[j].z, as, qv[j].z);
        v[j].w = acc_one(v[j].w, as, qv[j].w);
        *reinterpret_cast<float4*>(acc_r + i) = v[j];
      }
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
      const float as = L.bpr == 1 ? as_row : __fmul_rn(a, __ldg(s_r + i / L.block));
      acc_r[i] = acc_one(acc_r[i], as, __ldg(q_r + i));
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// B.5 (a mask) or B.3 (mask null) over n leaves, in place; see the entry
// points below.
int launch_accumulate(const long long* desc, int n, const float* w, const float* mask,
                      const long long* src, long long rows, long long rows_q, void* stream) {
  if (n <= 0 || n > kMaxLeaves || rows <= 0 || rows_q <= 0 ||
      (src == nullptr && rows_q != rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AccTable t = {};
  t.w = w;
  t.mask = mask;
  t.src = src;
  t.rows_q = rows_q;
  t.n = n;
  long long ctas = 0;
  for (int l = 0; l < n; ++l) {
    const long long* e = desc + kAccDesc * l;
    AccLeaf& L = t.leaf[l];
    L.acc = reinterpret_cast<float*>(e[0]);
    L.q = reinterpret_cast<const int8_t*>(e[1]);
    L.scales = reinterpret_cast<const float*>(e[2]);
    L.d = e[3];
    L.bpr = e[4];
    L.chunk_begin = e[5];
    if (L.d <= 0 || L.bpr <= 0 || L.d % L.bpr != 0 || L.chunk_begin != ctas) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    L.block = L.d / L.bpr;
    L.chunks = (L.d + kChunk - 1) / kChunk;
    L.vec = L.block % 4 == 0 && aligned(L.acc, 16) && aligned(L.q, 4);
    ctas += rows * L.chunks;
  }
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  masked_dequant_acc_grouped_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// B.4 (a mask) or B.2 (mask null) over n leaves; see the entry points
// below.
int launch_quantize(const long long* desc, int n, const float* mask, float qmax,
                    long long rows, void* stream) {
  if (n <= 0 || n > kMaxLeaves || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  QuantTable t = {};
  t.mask = mask;
  t.qmax = qmax;
  t.n = n;
  long long clusters = 0;
  for (int l = 0; l < n; ++l) {
    const long long* e = desc + kQuantDesc * l;
    QuantLeaf& L = t.leaf[l];
    L.x = reinterpret_cast<const float*>(e[0]);
    L.u = reinterpret_cast<const float*>(e[1]);
    L.q = reinterpret_cast<int8_t*>(e[2]);
    L.scales = reinterpret_cast<float*>(e[3]);
    const long long d = e[4];
    L.block = e[5];
    L.cluster_begin = e[6];
    if (d <= 0 || L.block <= 0 || d % L.block != 0 || L.cluster_begin != clusters) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    L.bpr = d / L.block;
    L.segments = rows * L.bpr;
    L.vec = L.block % 4 == 0 && aligned(L.x, 16) && aligned(L.u, 16) && aligned(L.q, 4);
    clusters += clusters_of(L.segments, L.block);
    // the shared-memory cache serves shares longer than a register tile
    // (and the scalar path's), up to kSmemCap floats
    const long long share = share_of(L.block);
    const bool uses_cache = !L.vec || share > kTile;
    if (uses_cache && share <= kSmemCap && share > t.smem_floats) t.smem_floats = share;
  }
  if (clusters > INT_MAX / kCluster) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(t.smem_floats) * sizeof(float);
  static const cudaError_t attrs = [] {
    cudaError_t e = cudaFuncSetAttribute(masked_quantize_grouped_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(masked_quantize_grouped_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kSmemCap * sizeof(float)));
  }();
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kCluster));
  cfg.blockDim = dim3(kQThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&t};
  cudaError_t err =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(masked_quantize_grouped_kernel),
                          args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The kernels' fixed sizes, for the caller's leaf table: {cluster size,
// leaves per launch, B.4's least share, B.5's chunk, B.4's shared-memory
// cap in floats}.
extern "C" void masked_grouped_config(long long* out) {
  out[0] = kCluster;
  out[1] = kMaxLeaves;
  out[2] = kMinShare;
  out[3] = kChunk;
  out[4] = kSmemCap;
}

// B.4 over n <= kMaxLeaves leaves of `rows` rows each.  desc holds, per
// leaf, kQuantDesc longs: x, u (float32, (rows, d)), q (int8, (rows, d)),
// scales (float32, (rows, d / block)), d, block (divides d), and the prefix
// count of clusters before it (per leaf: its rows * d / block segments, or
// a kCluster-th of them, rounded up, where a segment is packed).  mask:
// (rows,) float32.  Launches on `stream`; returns the cudaError_t (0 on
// success).
extern "C" int masked_quantize_grouped_f32(const long long* desc, int n, const float* mask,
                                           float qmax, long long rows, void* stream) {
  if (mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_quantize(desc, n, mask, qmax, rows, stream);
}

// B.2 over n <= kMaxLeaves leaves: B.4 with every mask entry 1.  The
// arguments are B.4's without the mask.
extern "C" int quantize_grouped_f32(const long long* desc, int n, float qmax, long long rows,
                                    void* stream) {
  return launch_quantize(desc, n, nullptr, qmax, rows, stream);
}

// B.5 over n <= kMaxLeaves leaves, in place.  desc holds, per leaf,
// kAccDesc longs: acc (float32, (rows, d)), q (int8, (rows_q, d)), scales
// (float32, (rows_q, bpr)), d, bpr (divides d), and the prefix count of
// CTAs (rows * ceil(d / kChunk) per leaf) before it.  w, mask: (rows,)
// float32; src: (rows,) int64 in [0, rows_q), or null for src[i] = i (then
// rows_q == rows).  Launches on `stream`; returns the cudaError_t.
extern "C" int masked_dequant_accumulate_grouped_f32(const long long* desc, int n,
                                                     const float* w, const float* mask,
                                                     const long long* src, long long rows,
                                                     long long rows_q, void* stream) {
  if (mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_accumulate(desc, n, w, mask, src, rows, rows_q, stream);
}

// B.3 over n <= kMaxLeaves leaves, in place: B.5 with every mask entry 1.
// The arguments are B.5's without the mask.
extern "C" int dequant_accumulate_grouped_f32(const long long* desc, int n, const float* w,
                                              const long long* src, long long rows,
                                              long long rows_q, void* stream) {
  return launch_accumulate(desc, n, w, nullptr, src, rows, rows_q, stream);
}
