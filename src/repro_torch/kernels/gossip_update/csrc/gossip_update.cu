// The fused DR-DSGD local update and neighbour combine (paper Eq. 9 / Eq. 20),
// for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gossip_update/kernel.py
// (`_gossip_update_kernel`, `gossip_update`, pallas_call :54).  Two entry
// points:
//
//   gossip_update_<t>          the reference's per-node form: for one node
//       out = W_ii (theta - eta s g) + sum_n W_in nbr_n
//       with theta, g (D,), the neighbours' updated parameters nbr (N, D),
//       weights (N+1,) (self weight first) and the node's scale s (),
//       accumulated in float32 and returned in theta's dtype;
//       out = weights[0] (theta - eta s g) when N = 0.
//   gossip_update_stacked_<t>  every node of a node-stacked leaf at once,
//       the form the decentralized train step runs:
//       u_j   = theta_j - eta (g_j s_j)          (j = 0..K-1)
//       out_i = sum_j W_ij u_j                   (i = 0..K-1)
//       with theta, g (K, D), W (K, K) and s (K,).
//
// eta is a runtime argument (SGD's schedule gives it per step), not a
// compile-time constant as on the TPU; W, the weights and the scales are
// read from device memory, so nothing waits for the host.
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
// is an FMA chain over j = 0..K-1, and the two agree within rounding.
//
// Bound: memory.  The stacked form reads theta and g once and writes out
// once, 3 K D elements (at K = 8, the qwen2-0.5b node-stacked parameters:
// 47.4 GB, 14.2 ms at 3.35 TB/s), against 2 K^2 D + 3 K D float operations:
// at K <= 64 below the card's float32 ridge.  The per-node form moves
// (N + 3) D elements.
//
// Design.  One thread per column d.  The stacked form loads the K values of
// theta and g of its column once, forms u_j in registers (an array of
// KMAX = 8, 16, 32 or 64 entries, the smallest that holds K; the wrapper
// raises above 64) and writes every out_i, with W and s staged in shared
// memory (every thread reads the same W_ij: a broadcast).  Neighbouring
// threads read neighbouring columns of each row, so every load and store is
// coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
gossip_update_kernel(const T* __restrict__ theta, const T* __restrict__ grad,
                     const T* __restrict__ nbrs, const float* __restrict__ weights,
                     const float* __restrict__ scale, T* __restrict__ out, long long d,
                     int n, long long nbr_stride, float eta) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= d) return;
  const float es = __fmul_rn(eta, __ldg(scale));
  const float upd = __fsub_rn(load(theta + c), __fmul_rn(es, load(grad + c)));
  float acc = __fmul_rn(__ldg(weights), upd);
  for (int j = 0; j < n; ++j) {
    acc = __fadd_rn(acc, __fmul_rn(__ldg(weights + j + 1), load(nbrs + j * nbr_stride + c)));
  }
  store(out + c, acc);
}

template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads)
gossip_update_stacked_kernel(const T* __restrict__ theta, const T* __restrict__ grad,
                             const float* __restrict__ w, const float* __restrict__ scale,
                             T* __restrict__ out, int k, long long d, float eta) {
  __shared__ float w_s[KMAX * KMAX];
  __shared__ float s_s[KMAX];
  for (int i = threadIdx.x; i < k * k; i += kThreads) w_s[i] = __ldg(w + i);
  for (int i = threadIdx.x; i < k; i += kThreads) {
    s_s[i] = round_to(__ldg(scale + i), theta);  // the scale in the leaf's dtype
  }
  __syncthreads();
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= d) return;
  float u[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      const float gs = round_to(__fmul_rn(load(grad + j * d + c), s_s[j]), theta);
      const float step = round_to(__fmul_rn(eta, gs), theta);
      u[j] = round_to(__fsub_rn(load(theta + j * d + c), step), theta);
    }
  }
  for (int i = 0; i < k; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) acc = __fmaf_rn(w_s[i * k + j], u[j], acc);
    }
    store(out + i * d + c, acc);
  }
}

unsigned blocks(long long d) { return static_cast<unsigned>((d + kThreads - 1) / kThreads); }

template <typename T>
int per_node(const T* theta, const T* grad, const T* nbrs, const float* weights,
             const float* scale, T* out, long long d, int n, long long nbr_stride, float eta,
             cudaStream_t stream) {
  if (d <= 0) return cudaSuccess;
  gossip_update_kernel<T><<<blocks(d), kThreads, 0, stream>>>(theta, grad, nbrs, weights, scale,
                                                              out, d, n, nbr_stride, eta);
  return cudaGetLastError();
}

template <typename T>
int stacked(const T* theta, const T* grad, const float* w, const float* scale, T* out, int k,
            long long d, float eta, cudaStream_t stream) {
  if (d <= 0) return cudaSuccess;
  if (k <= 8) {
    gossip_update_stacked_kernel<T, 8><<<blocks(d), kThreads, 0, stream>>>(theta, grad, w, scale,
                                                                           out, k, d, eta);
  } else if (k <= 16) {
    gossip_update_stacked_kernel<T, 16><<<blocks(d), kThreads, 0, stream>>>(theta, grad, w, scale,
                                                                            out, k, d, eta);
  } else if (k <= 32) {
    gossip_update_stacked_kernel<T, 32><<<blocks(d), kThreads, 0, stream>>>(theta, grad, w, scale,
                                                                            out, k, d, eta);
  } else if (k <= 64) {
    gossip_update_stacked_kernel<T, 64><<<blocks(d), kThreads, 0, stream>>>(theta, grad, w, scale,
                                                                            out, k, d, eta);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// theta, grad, out (D,); nbrs (N, D) with row stride nbr_stride (elements);
// weights (N+1,) and scale () float32 on the device.  Returns a cudaError_t.
extern "C" int gossip_update_f32(const float* theta, const float* grad, const float* nbrs,
                                 const float* weights, const float* scale, float* out,
                                 long long d, int n, long long nbr_stride, float eta,
                                 cudaStream_t stream) {
  return per_node(theta, grad, nbrs, weights, scale, out, d, n, nbr_stride, eta, stream);
}

extern "C" int gossip_update_bf16(const __nv_bfloat16* theta, const __nv_bfloat16* grad,
                                  const __nv_bfloat16* nbrs, const float* weights,
                                  const float* scale, __nv_bfloat16* out, long long d, int n,
                                  long long nbr_stride, float eta, cudaStream_t stream) {
  return per_node(theta, grad, nbrs, weights, scale, out, d, n, nbr_stride, eta, stream);
}

// theta, grad, out (K, D) row-major; w (K, K) and scale (K,) float32 on the
// device; K <= 64.  Returns a cudaError_t.
extern "C" int gossip_update_stacked_f32(const float* theta, const float* grad, const float* w,
                                         const float* scale, float* out, int k, long long d,
                                         float eta, cudaStream_t stream) {
  return stacked(theta, grad, w, scale, out, k, d, eta, stream);
}

extern "C" int gossip_update_stacked_bf16(const __nv_bfloat16* theta,
                                          const __nv_bfloat16* grad, const float* w,
                                          const float* scale, __nv_bfloat16* out, int k,
                                          long long d, float eta, cudaStream_t stream) {
  return stacked(theta, grad, w, scale, out, k, d, eta, stream);
}
