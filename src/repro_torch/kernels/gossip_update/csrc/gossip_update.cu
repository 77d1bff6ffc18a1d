// The fused DR-DSGD local update and neighbour combine (paper Eq. 9 / Eq. 20),
// for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gossip_update/kernel.py
// (`_gossip_update_kernel`, `gossip_update`, pallas_call :54).  Two entry
// points:
//
//   gossip_update_nodes_<t>            the reference's per-node form over
//       every leaf l of one node's tree at once (one leaf is a group of one):
//       out_l = W_ii (theta_l - eta s g_l) + sum_n W_in nbr_{n,l}
//       with theta_l, g_l (D_l,), the neighbours' updated parameters
//       nbr_{n,l} (D_l,) each, weights (N+1,) (self weight first) and the
//       node's scale s (), accumulated in float32 and returned in theta's
//       dtype; out = weights[0] (theta - eta s g) when N = 0.
//   gossip_update_stacked_grouped_<t>  every node of every node-stacked
//       leaf of a group at once, the form the decentralized train step
//       runs (one launch per step over every leaf; one leaf is a group of
//       one):
//       u_j   = theta_j - eta (g_j s_j)          (j = 0..K-1)
//       out_i = sum_j W_ij u_j                   (i = 0..K-1)
//       with theta, g (K, D_l) per leaf l, W (K, K) and s (K,).
//
// eta is a runtime argument (SGD's schedule gives it per step), not a
// compile-time constant as on the TPU: a float argument of the per-node
// form, and read from device memory (a 0-d float32 tensor, once per CTA) by
// the stacked form, so a captured CUDA graph of the train step replays each
// step's eta as the host wrote it before the replay.  W, the weights and
// the scales are read from device memory, so nothing waits for the host.
// The stacked form writes into output leaves the caller gives, which may be
// theta itself (the captured train step updates its parameters in place):
// every node's output column reads every node's input column, and the one
// thread that owns a column loads all K rows of it before it stores any, so
// no thread reads a column another has written.  theta is read by plain
// (coherent) loads, not the read-only path's __ldg, since the kernel may
// write it.
//
// Arithmetic.  Each elementwise product and difference is rounded once, in
// the order of the plain PyTorch version (ref.py) — (eta s) g for the
// per-node form (the Pallas source order), eta (g s) for the stacked form
// (the unfused train step: scale, then SGD) — with __fmul_rn/__fsub_rn so
// nvcc does not contract them into FMAs; in bfloat16 the stacked form rounds
// g s and eta (g s) and theta - eta (g s) to bfloat16 as the unfused
// step's bfloat16 tensors do.  The per-node neighbour sum adds one rounded
// product at a time, as the plain version's loop does, so the two are
// bit-equal.  The stacked form's sum over j is the plain version's matrix
// product (cuBLAS on the card), which sums in an order of its own: here it
// is an FMA chain over j = 0..K-1 from 0, and the two agree within
// rounding.  Every leaf of a group, and a leaf alone, gets the same chain,
// so the grouped and one-leaf launches give the same bits.
//
// Design of the per-node form.  The leaves go to the kernel by value, as a
// __grid_constant__ table like the stacked form's: theta, g and out
// pointers, D and the CTAs of the launch's earlier leaves per leaf, and
// every leaf's neighbour pointers in one pool of kNbrPool (leaf l's
// neighbour n at l N + n), so the neighbours' rows are read where they lie:
// no stacked copy.  A group of more than kMaxLeaves leaves, or of more
// leaves than the pool holds at N, is split by the caller.  Each CTA covers
// kCols columns of one leaf, a thread 4 columns kThreads apart (coalesced).
//
// Bound: memory.  The stacked form reads theta and g once and writes out
// once, 3 K D elements (at K = 8, the qwen2-0.5b node-stacked parameters:
// 47.4 GB, 14.2 ms at 3.35 TB/s), against 2 K^2 D + 3 K D float operations:
// at K <= 64 below the card's float32 ridge.  At the fmnist MLP's widths
// (K = 10, 6 leaves, 13.1 MB: 3.9 us) the bytes take less time than one
// launch's fixed cost, so the group is one launch.  The per-node form moves
// (N + 3) D elements.
//
// Design of the stacked form.
// * Grouping.  The leaves go to the kernel by value, as a __grid_constant__
//   table (theta, g and out pointers, D, the CTAs of the launch's earlier
//   leaves); a CTA finds its leaf by a scan of at most kMaxLeaves entries.
//   Larger groups are split by the caller.  Each CTA covers kCols columns
//   of one leaf, all K rows.
// * A thread takes kCols / kThreads = 4 columns: V side by side (16-byte
//   loads of float32, 8-byte of bfloat16 at K <= 8; V = 2 at K <= 16; V = 1
//   above, where V K values of theta and g per thread would not fit the
//   registers), in 4 / V passes; a leaf whose D or pointers do not allow
//   the vector width takes its 4 columns one at a time.  Neighbouring
//   threads read neighbouring columns of each row: every load and store is
//   coalesced.
// * W and s are staged in shared memory behind one __syncthreads, before
//   the first load of theta and g (issuing those first, to overlap the two
//   latencies, measured no faster: tests/b1_variants.py); every thread then
//   reads the same W_ij, a broadcast.  W is kept with a row stride of KMAX,
//   so the unrolled sum over j reads it at fixed offsets.
// * Rows i and i + 1 are summed side by side (2 V independent FMA chains
//   per thread), each chain in the order j = 0..K-1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 16;             // leaves per stacked launch
constexpr int kMaxNodes = 64;              // the stacked form's largest K
constexpr int kColsPerThread = 4;
constexpr long long kCols = static_cast<long long>(kThreads) * kColsPerThread;  // per CTA
constexpr int kStackedDesc = 5;            // longs per leaf in a stacked descriptor
constexpr int kNodeDesc = 5;               // longs per leaf in a per-node descriptor
constexpr int kNbrPool = 384;              // neighbour pointers per per-node launch

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// a float32 result rounded to T, as a T tensor op stores it
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// -- the per-node form, grouped -----------------------------------------------

template <typename T>
struct NodeLeaf {
  const T* theta;
  const T* grad;
  T* out;
  long long d;          // columns
  long long cta_begin;  // CTAs of the launch's earlier leaves
};

template <typename T>
struct NodeTable {
  NodeLeaf<T> leaf[kMaxLeaves];
  const T* nbr[kNbrPool];  // leaf l's neighbour n at l * n_nbrs + n
  const float* weights;    // (N + 1,), the self weight first
  const float* scale;      // ()
  float eta;
  int n;        // leaves
  int n_nbrs;   // N
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
gossip_update_kernel(const __grid_constant__ NodeTable<T> t) {
  const long long cta = blockIdx.x;
  int l = 0;
  while (l + 1 < t.n && cta >= t.leaf[l + 1].cta_begin) ++l;
  const NodeLeaf<T>& L = t.leaf[l];
  const T* const* nbr = t.nbr + l * t.n_nbrs;
  const long long c0 = (cta - L.cta_begin) * kCols + threadIdx.x;
  const float es = __fmul_rn(t.eta, __ldg(t.scale));
  const float w0 = __ldg(t.weights);
#pragma unroll 1
  for (int p = 0; p < kColsPerThread; ++p) {
    const long long c = c0 + static_cast<long long>(p) * kThreads;
    if (c >= L.d) break;
    const float upd = __fsub_rn(load(L.theta + c), __fmul_rn(es, load(L.grad + c)));
    float acc = __fmul_rn(w0, upd);
#pragma unroll 4
    for (int j = 0; j < t.n_nbrs; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(__ldg(t.weights + j + 1), load(nbr[j] + c)));
    }
    store(L.out + c, acc);
  }
}

// -- the stacked form, grouped ---------------------------------------------------

// one load: by the read-only path (RO), or a plain coherent one (memory the
// kernel may write)
template <bool RO, typename U>
__device__ __forceinline__ U ld(const U* p) {
  return RO ? __ldg(p) : *p;
}

// V consecutive elements at p (aligned to V elements) as float32
template <bool RO>
__device__ __forceinline__ void load_v(const float* p, float (&o)[1]) { o[0] = ld<RO>(p); }
template <bool RO>
__device__ __forceinline__ void load_v(const float* p, float (&o)[2]) {
  const float2 v = ld<RO>(reinterpret_cast<const float2*>(p));
  o[0] = v.x;
  o[1] = v.y;
}
template <bool RO>
__device__ __forceinline__ void load_v(const float* p, float (&o)[4]) {
  const float4 v = ld<RO>(reinterpret_cast<const float4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
// a bfloat16 is the high half of its float32: element 2m is word m's low half
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
template <bool RO>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float (&o)[1]) {
  o[0] = __bfloat162float(*p);
}
template <bool RO>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float (&o)[2]) {
  const unsigned w = ld<RO>(reinterpret_cast<const unsigned*>(p));
  o[0] = bf16_lo(w);
  o[1] = bf16_hi(w);
}
template <bool RO>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 w = ld<RO>(reinterpret_cast<const uint2*>(p));
  o[0] = bf16_lo(w.x);
  o[1] = bf16_hi(w.x);
  o[2] = bf16_lo(w.y);
  o[3] = bf16_hi(w.y);
}

__device__ __forceinline__ void store_v(float* p, const float (&a)[1]) { *p = a[0]; }
__device__ __forceinline__ void store_v(float* p, const float (&a)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
}
__device__ __forceinline__ void store_v(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float (&a)[1]) {
  *p = __float2bfloat16_rn(a[0]);
}
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float (&a)[2]) {
  *reinterpret_cast<unsigned*>(p) = bf16_pair(a[0], a[1]);
}
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float (&a)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(a[0], a[1]), bf16_pair(a[2], a[3]));
}

// Columns side by side per thread at KMAX nodes: V K values of theta and of
// g per pass stay within 64 registers.
__host__ __device__ constexpr int vec_width(int kmax) {
  return kmax <= 8 ? 4 : (kmax <= 16 ? 2 : 1);
}

template <typename T>
struct StackedLeaf {
  const T* theta;
  const T* grad;
  T* out;
  long long d;          // columns (elements per node)
  long long cta_begin;  // CTAs of the launch's earlier leaves
  int vec;              // V columns per load and store
};

template <typename T>
struct StackedTable {
  StackedLeaf<T> leaf[kMaxLeaves];
  const float* w;      // (K, K)
  const float* scale;  // (K,)
  const float* eta;    // ()
  int k;
  int n;
};

// theta and g of W <= V columns from c, every node, into th[j][0..W) and
// gr[j][0..W)
template <typename T, int KMAX, int V, int W>
__device__ __forceinline__ void load_cols(const StackedLeaf<T>& L, int k, long long c,
                                          float (&th)[KMAX][V], float (&gr)[KMAX][V]) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      float a[W], b[W];
      load_v<false>(L.theta + j * L.d + c, a);  // out may be theta
      load_v<true>(L.grad + j * L.d + c, b);
#pragma unroll
      for (int v = 0; v < W; ++v) {
        th[j][v] = a[v];
        gr[j][v] = b[v];
      }
    }
  }
}

// u_j into th, then every out_i of the W columns from c
template <typename T, int KMAX, int V, int W>
__device__ __forceinline__ void mix_cols(const StackedLeaf<T>& L, int k, long long c, float eta,
                                         const float* w_s, const float* s_s,
                                         float (&th)[KMAX][V], const float (&gr)[KMAX][V]) {
  const T* tag = nullptr;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
#pragma unroll
      for (int v = 0; v < W; ++v) {
        const float gs = round_to(__fmul_rn(gr[j][v], s_s[j]), tag);
        const float step = round_to(__fmul_rn(eta, gs), tag);
        th[j][v] = round_to(__fsub_rn(th[j][v], step), tag);
      }
    }
  }
  for (int i = 0; i < k; i += 2) {
    const int i1 = min(i + 1, k - 1);  // an odd K sums its last row twice, stores it once
    const float* w0 = w_s + i * KMAX;
    const float* w1 = w_s + i1 * KMAX;
    float a0[W], a1[W];
#pragma unroll
    for (int v = 0; v < W; ++v) {
      a0[v] = 0.f;
      a1[v] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
#pragma unroll
        for (int v = 0; v < W; ++v) {
          a0[v] = __fmaf_rn(w0[j], th[j][v], a0[v]);
          a1[v] = __fmaf_rn(w1[j], th[j][v], a1[v]);
        }
      }
    }
    store_v(L.out + i * L.d + c, a0);
    if (i + 1 < k) store_v(L.out + i1 * L.d + c, a1);
  }
}

template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads)
gossip_update_stacked_grouped_kernel(const __grid_constant__ StackedTable<T> t) {
  constexpr int V = vec_width(KMAX);
  __shared__ float w_s[KMAX * KMAX];  // row i at i * KMAX
  __shared__ float s_s[KMAX];
  const long long cta = blockIdx.x;
  int l = 0;
  while (l + 1 < t.n && cta >= t.leaf[l + 1].cta_begin) ++l;
  const StackedLeaf<T>& L = t.leaf[l];
  const int k = t.k;
  const float eta = __ldg(t.eta);
  const long long c0 = (cta - L.cta_begin) * kCols;
  for (int i = threadIdx.x; i < k * k; i += kThreads) w_s[(i / k) * KMAX + i % k] = __ldg(t.w + i);
  for (int i = threadIdx.x; i < k; i += kThreads) {
    s_s[i] = round_to(__ldg(t.scale + i), L.theta);  // the scale in the leaf's dtype
  }
  __syncthreads();

  // a vector leaf: passes of V columns side by side from cv; else one
  // column at a time from c1
  const long long cv = c0 + static_cast<long long>(threadIdx.x) * V;
  const long long c1 = c0 + threadIdx.x;
  float th[KMAX][V], gr[KMAX][V];
  if (V > 1 && L.vec) {
#pragma unroll 1
    for (int p = 0; p < kColsPerThread / V; ++p) {
      const long long c = cv + static_cast<long long>(p) * kThreads * V;
      if (c >= L.d) break;
      load_cols<T, KMAX, V, V>(L, k, c, th, gr);
      mix_cols<T, KMAX, V, V>(L, k, c, eta, w_s, s_s, th, gr);
    }
    return;
  }
#pragma unroll 1
  for (int p = 0; p < kColsPerThread; ++p) {
    const long long c = c1 + static_cast<long long>(p) * kThreads;
    if (c >= L.d) break;
    load_cols<T, KMAX, V, 1>(L, k, c, th, gr);
    mix_cols<T, KMAX, V, 1>(L, k, c, eta, w_s, s_s, th, gr);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int per_node(const long long* desc, int n, const long long* nbrs, int n_nbrs,
             const float* weights, const float* scale, float eta, cudaStream_t stream) {
  if (n <= 0 || n > kMaxLeaves || n_nbrs < 0 || n * n_nbrs > kNbrPool)
    return cudaErrorInvalidValue;
  NodeTable<T> t = {};
  t.weights = weights;
  t.scale = scale;
  t.eta = eta;
  t.n = n;
  t.n_nbrs = n_nbrs;
  long long ctas = 0;
  for (int l = 0; l < n; ++l) {
    const long long* e = desc + kNodeDesc * l;
    NodeLeaf<T>& L = t.leaf[l];
    L.theta = reinterpret_cast<const T*>(e[0]);
    L.grad = reinterpret_cast<const T*>(e[1]);
    L.out = reinterpret_cast<T*>(e[2]);
    L.d = e[3];
    L.cta_begin = e[4];
    if (L.d <= 0 || L.cta_begin != ctas) return cudaErrorInvalidValue;
    ctas += (L.d + kCols - 1) / kCols;
  }
  for (int i = 0; i < n * n_nbrs; ++i) t.nbr[i] = reinterpret_cast<const T*>(nbrs[i]);
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  gossip_update_kernel<T><<<static_cast<unsigned>(ctas), kThreads, 0, stream>>>(t);
  return cudaGetLastError();
}

template <typename T, int KMAX>
int launch_stacked(const StackedTable<T>& t, long long ctas, cudaStream_t stream) {
  gossip_update_stacked_grouped_kernel<T, KMAX>
      <<<static_cast<unsigned>(ctas), kThreads, 0, stream>>>(t);
  return cudaGetLastError();
}

template <typename T>
int stacked_grouped(const long long* desc, int n, const float* w, const float* scale, int k,
                    const float* eta, cudaStream_t stream) {
  if (n <= 0 || n > kMaxLeaves || k <= 0 || k > kMaxNodes || eta == nullptr)
    return cudaErrorInvalidValue;
  const int kmax = k <= 8 ? 8 : (k <= 16 ? 16 : (k <= 32 ? 32 : 64));
  const int v = vec_width(kmax);
  StackedTable<T> t = {};
  t.w = w;
  t.scale = scale;
  t.eta = eta;
  t.k = k;
  t.n = n;
  long long ctas = 0;
  for (int l = 0; l < n; ++l) {
    const long long* e = desc + kStackedDesc * l;
    StackedLeaf<T>& L = t.leaf[l];
    L.theta = reinterpret_cast<const T*>(e[0]);
    L.grad = reinterpret_cast<const T*>(e[1]);
    L.out = reinterpret_cast<T*>(e[2]);
    L.d = e[3];
    L.cta_begin = e[4];
    if (L.d <= 0 || L.cta_begin != ctas) return cudaErrorInvalidValue;
    const uintptr_t bytes = static_cast<uintptr_t>(v) * sizeof(T);
    L.vec = v > 1 && L.d % v == 0 && aligned(L.theta, bytes) && aligned(L.grad, bytes) &&
            aligned(L.out, bytes);
    ctas += (L.d + kCols - 1) / kCols;
  }
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  switch (kmax) {
    case 8: return launch_stacked<T, 8>(t, ctas, stream);
    case 16: return launch_stacked<T, 16>(t, ctas, stream);
    case 32: return launch_stacked<T, 32>(t, ctas, stream);
    default: return launch_stacked<T, 64>(t, ctas, stream);
  }
}

}  // namespace

// The fixed sizes, for the caller's leaf tables: {leaves per launch, the
// stacked form's largest K, columns per CTA, the per-node form's pool of
// neighbour pointers}.
extern "C" void gossip_update_config(long long* out) {
  out[0] = kMaxLeaves;
  out[1] = kMaxNodes;
  out[2] = kCols;
  out[3] = kNbrPool;
}

// The per-node form over n <= kMaxLeaves leaves of one node.  desc holds,
// per leaf, kNodeDesc longs: theta, grad, out ((d,), of the entry point's
// dtype), d, and the prefix count of CTAs (ceil(d / kCols) per leaf) before
// it; nbrs n * n_nbrs pointers (leaf l's neighbour j at l * n_nbrs + j, each
// (d,) of the leaf's d), n * n_nbrs <= kNbrPool; weights (n_nbrs + 1,) and
// scale () float32 on the device.  Returns a cudaError_t.
extern "C" int gossip_update_nodes_f32(const long long* desc, int n, const long long* nbrs,
                                       int n_nbrs, const float* weights, const float* scale,
                                       float eta, cudaStream_t stream) {
  return per_node<float>(desc, n, nbrs, n_nbrs, weights, scale, eta, stream);
}

extern "C" int gossip_update_nodes_bf16(const long long* desc, int n, const long long* nbrs,
                                        int n_nbrs, const float* weights, const float* scale,
                                        float eta, cudaStream_t stream) {
  return per_node<__nv_bfloat16>(desc, n, nbrs, n_nbrs, weights, scale, eta, stream);
}

// The stacked form over n <= kMaxLeaves leaves of K <= kMaxNodes nodes each.
// desc holds, per leaf, kStackedDesc longs: theta, grad, out ((K, d)
// row-major, of the entry point's dtype), d, and the prefix count of CTAs
// (ceil(d / kCols) per leaf) before it.  w (K, K), scale (K,) and eta ()
// float32 on the device.  Launches on `stream`; returns a cudaError_t.
extern "C" int gossip_update_stacked_grouped_f32(const long long* desc, int n, const float* w,
                                                 const float* scale, int k, const float* eta,
                                                 cudaStream_t stream) {
  return stacked_grouped<float>(desc, n, w, scale, k, eta, stream);
}

extern "C" int gossip_update_stacked_grouped_bf16(const long long* desc, int n, const float* w,
                                                  const float* scale, int k, const float* eta,
                                                  cudaStream_t stream) {
  return stacked_grouped<__nv_bfloat16>(desc, n, w, scale, k, eta, stream);
}
